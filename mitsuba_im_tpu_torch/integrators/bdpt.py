"""Bidirectional path tracer with full multiple-importance sampling
(``mitsuba_im_tpu/integrators/bdpt.py``).

Eye and light subpaths are traced independently over the flat SoA
wavefront, every (s light, t eye) pairing is connected, and each
strategy's contribution is weighted by the balance heuristic over all the
strategies that could have made the same path (Veach's MIS, the
reference's ``Path::misWeight``), with PBRT's pdf_fwd/pdf_rev
bookkeeping.  A subpath is a list of vertex dicts, one per static vertex
index, built by a Python loop over a static depth (:func:`random_walk`);
every strategy and every MIS weight (:func:`mis_weight`) is a Python loop
over static indices, so the number of intersection launches a pass is
fixed: max_depth closest-hit calls on the eye side and max_depth - 1 on
the light side, and one any-hit call per s = 1, t = 1 and inner
connection that fits the depth.

Strategies (a path of k = s + t - 1 edges <= max_depth):
  - s = 0: the eye path hits an emitter, or escapes to the environment
    (a pseudo-vertex at infinity, weighted against NEE and the light
    subpath's strategies in the solid-angle measure);
  - s = 1, t >= 2: next-event estimation from each eye vertex;
  - t = 1, s >= 2: light tracing, a light vertex connected to the camera
    and splatted at its own pixel (the light image);
  - s >= 2, t >= 2: inner connections with the geometry term and one
    visibility test.
Light subpaths apply Veach's shading-normal correction
(:func:`_adjoint_correction`) along the walk and at connections.  Light
subpaths start from area, point and spot lights and from the
environments and directional lights (a direction first, then a point on
the bounding disk perpendicular to it); collimated beams start none.

Participating media: walks place medium vertices where a scattering
medium's channel-averaged free flight beats the surface hit, with volume
densities (distance pdf, no cosine, :func:`_conv_density`); every
connection edge carries Beer-Lambert transmittance, ratio-tracked on grid
lanes (:func:`_seg_tr`) with a counter stream of its own (seed ^
0xA5D1C0DE) so that the edges never move the subpaths' draws.  The
reference's approximations are copied: a connection edge takes its
eye-side endpoint's medium for the whole segment, and grid media get
ratio-tracked edges but no medium vertices (their ``sigma_s`` row is 0).

Phase functions (ROADMAP C16): the reference evaluates and samples the
medium vertices' phase through ``phase_eval``/``phase_sample``, which know
isotropic, HG and Rayleigh only, so a Kajiya-Kay, microflake or mixture
medium gets an isotropic lobe there.  The port goes through the phase
context (``media/medium.py::phase_ctx_v``, ``phase_eval_ctx_v``,
``phase_pdf_ctx_v``, ``phase_sample_ctx_v``, wi toward the previous
vertex, C4): f is the phase value (sigma_s is in the arrival weight), the
forward and reverse densities are its sampling pdf, and a structured
phase's sampling weight eval / pdf multiplies the throughput.  The ctx
sampler's third uniform, the mixture's component pick, is the medium
block's fourth draw, which the reference leaves unused; on isotropic, HG
and Rayleigh media the values and the draws are the reference's.

The light image sums each pass's splats with ``index_put_`` and
accumulate, not the reference's ``.at[].add``, for the same reason as the
box film (``film/film.py``): ``index_add_``'s atomics order the sums
differently run to run on the card; its zero splats go to a pixel of
their own lane, as the box film's inactive samples do.  ``li`` and the
splat values pass through ``nan_to_num`` as in the reference.
"""
from __future__ import annotations

import torch

from ..core.types import Float, Int, INVALID, EPSILON, SHADOW_EPSILON
from ..core import v3 as v
from ..core.v3 import V3, PI
from ..core import rng as mrng
from ..bsdf.common import lane_is_delta
from ..bsdf.eval import bsdf_eval_v, bsdf_pdf_v, bsdf_sample_v
from ..emitter import table as em
from ..film.film import F_BOX, make_film, splat as film_splat, \
    spread_inactive
from ..media import medium as med
from ..scene.scene import Scene
from ..sensor.table import connect_v, sample_ray_v
from .volpath import _medium_transition_v

BIG_T = 1.0e30  # "no event" distance
MED_SEED = 0xA5D1C0DE  # the edges' transmittance stream


def _remap0(x):
    return torch.where(x != 0.0, x, 1.0)


def _dist2(a: V3, b: V3):
    d = b - a
    return d.dot(d)


def _dir(a: V3, b: V3) -> V3:
    d = b - a
    return d * torch.rsqrt(torch.clamp_min(d.dot(d), 1e-20))


def _to_area(pdf_sa, from_p: V3, to_p: V3, to_n: V3):
    """Solid-angle density at ``from_p`` -> area density at ``to_p``."""
    d2 = _dist2(from_p, to_p)
    d = (to_p - from_p) * torch.rsqrt(torch.clamp_min(d2, 1e-20))
    return pdf_sa * torch.abs(to_n.dot(d)) / torch.clamp_min(d2, 1e-20)


def _seg_sigma(scene: Scene, mid):
    """The distance-sampling density sigma-bar of a segment's medium: the
    channel mean of sigma_t where the medium scatters (mean sigma_s > 0),
    0 in pure absorbers and vacuum."""
    ss, st, _pt, _g = med.medium_params_v(scene.media, mid)
    ss_mean = (ss.x + ss.y + ss.z) / 3.0
    st_bar = (st.x + st.y + st.z) / 3.0
    return torch.where(ss_mean > 0, st_bar, 0.0)


def _conv_density(scene: Scene, pdf_sa, from_p: V3, to_p: V3, to_n: V3,
                  to_is_med, seg_mid, has_media: bool):
    """Solid-angle density -> area or volume density at ``to_p`` with the
    segment medium's free-flight factor (PBRT's ConvertDensity with
    distance sampling): a surface target picks up e^{-sigma-bar d}, a
    medium target sigma-bar e^{-sigma-bar d} and no cosine."""
    d2 = _dist2(from_p, to_p)
    dist = torch.sqrt(torch.clamp_min(d2, 1e-20))
    dvec = (to_p - from_p) / dist
    cosf = torch.abs(to_n.dot(dvec))
    if not has_media:
        return pdf_sa * cosf / torch.clamp_min(d2, 1e-20)
    sbar = _seg_sigma(scene, seg_mid)
    atten = torch.exp(-sbar * dist)
    fac = torch.where(to_is_med, sbar * atten, atten)
    cosf = torch.where(to_is_med, 1.0, cosf)
    return pdf_sa * cosf * fac / torch.clamp_min(d2, 1e-20)


def _frame(vx: dict):
    return (vx["ss"], vx["ts"], vx["ns"])


def _vertex_f(scene: Scene, vx: dict, wo_world: V3, has_media: bool,
              adjoint: bool = False) -> V3:
    """Scattering throughput at a vertex toward ``wo_world``: the BSDF
    (cosine included) at surfaces, with the shading-normal correction for
    importance transport; the phase value at medium vertices (sigma_s is
    in the arrival weight)."""
    wo_local = v.to_local(_frame(vx), wo_world)
    f = bsdf_eval_v(vx["bp"], vx["wi_local"], wo_local)
    if adjoint:
        wi_w = v.to_world(_frame(vx), vx["wi_local"])
        f = f * _adjoint_correction(vx["ns"], vx["ng"], wi_w, wo_world)
    if not has_media:
        return f
    ph = med.phase_eval_ctx_v(scene.media, vx["ctx"], vx["wi_world"],
                              wo_world)
    return v.where(vx["is_med"], V3(ph, ph, ph), f)


def _vertex_pdf(scene: Scene, vx: dict, wo_world: V3, has_media: bool,
                reverse: bool = False):
    """Solid-angle density of sampling ``wo_world`` at the vertex, or with
    ``reverse`` of sampling its arrival direction given wo."""
    wo_local = v.to_local(_frame(vx), wo_world)
    if reverse:
        pdf = bsdf_pdf_v(vx["bp"], wo_local, vx["wi_local"])
    else:
        pdf = bsdf_pdf_v(vx["bp"], vx["wi_local"], wo_local)
    if not has_media:
        return pdf
    if reverse:
        ph = med.phase_pdf_ctx_v(scene.media, vx["ctx"], wo_world,
                                 vx["wi_world"])
    else:
        ph = med.phase_pdf_ctx_v(scene.media, vx["ctx"], vx["wi_world"],
                                 wo_world)
    return torch.where(vx["is_med"], ph, pdf)


def _adjoint_correction(ns: V3, ng: V3, wi_world: V3, wo_world: V3):
    """Veach's shading-normal factor for importance transport,
    |wi.ns||wo.ng| / (|wi.ng||wo.ns|), clamped to [0, 10]."""
    num = torch.abs(wi_world.dot(ns)) * torch.abs(wo_world.dot(ng))
    den = torch.abs(wi_world.dot(ng)) * torch.abs(wo_world.dot(ns))
    return torch.clamp(torch.where(den > 1e-8,
                                   num / torch.clamp_min(den, 1e-8), 1.0),
                       0.0, 10.0)


# ---------------------------------------------------------------------------
# Subpath tracing
# ---------------------------------------------------------------------------

def random_walk(scene: Scene, sampler: mrng.Sampler3, o: V3, d: V3,
                beta0: V3, pdf_dir0, n_steps: int, start_p: V3, start_n: V3,
                adjoint: bool = False, infinite0=None, medium0=None):
    """Extend a subpath by up to ``n_steps`` surface or medium vertices.

    Returns (vertex list, sampler, escape record, reverse density at the
    origin).  A vertex holds its geometry and frame, the resolved BSDF
    parameters ``bp``, the throughput ``beta`` up to and including its
    arrival, its area or volume density ``pdf_fwd``, its reverse density
    ``pdf_rev`` (filled one step later), and flags; with media, its
    arrival-side medium ``mid``, ``is_med``, ``wi_world`` and its phase
    context ``ctx``.  With ``medium0`` (the lanes' starting media) each
    step draws a medium block first: its first uniform the free flight,
    the next three the phase sample."""
    verts = []
    s = sampler
    prev_p, prev_n = start_p, start_n
    cur_d = d
    beta = beta0
    pdf_dir = pdf_dir0
    n0 = pdf_dir0.shape[0]
    dev = pdf_dir0.device
    no = torch.zeros((n0,), dtype=torch.bool, device=dev)
    pdf_delta = no
    alive = torch.ones((n0,), dtype=torch.bool, device=dev)
    escape = None
    start_rev = torch.zeros((n0,), dtype=Float, device=dev)
    mid = medium0
    has_media = mid is not None
    prev_is_med = no
    one = v.ones((n0,), dev)

    for i in range(n_steps):
        hit = scene.ray_intersect_v(prev_p, cur_d)
        it = scene.interaction_v(prev_p, cur_d, hit)
        surf_ok = alive & it.valid

        if has_media:
            s, mblk = mrng.next_block4_v(s)
            ss_m, st_m, _pt, _g = med.medium_params_v(scene.media, mid)
            sbar = _seg_sigma(scene, mid)
            t_m = torch.where(
                sbar > 0,
                -torch.log(torch.clamp_min(1.0 - mblk[0], 1e-20))
                / torch.clamp_min(sbar, 1e-20), BIG_T)
            t_surf = torch.where(it.valid, hit.t, BIG_T)
            in_scat = alive & (sbar > 0) & (t_m < t_surf)
            t_fin = torch.where(in_scat, t_m, t_surf)
            tr_full = med.transmittance_v(st_m, torch.clamp_max(t_fin,
                                                                1e30))
            pdf_t = torch.clamp_min(sbar, 1e-20) * torch.exp(-sbar * t_m)
            p_surf = torch.exp(-sbar * torch.clamp_max(t_surf, 1e30))
            w_med = tr_full * (ss_m / pdf_t)
            w_srf = tr_full / torch.clamp_min(p_surf, 1e-20)
            w_arr = v.where(in_scat, w_med, w_srf)
            # escapes through a medium: transmittance 0
            esc_kill = (alive & ~it.valid & ~in_scat) & (
                (st_m.x + st_m.y + st_m.z) / 3.0 > 0)
            beta = beta * v.where(surf_ok | in_scat, w_arr, one)
            beta = v.where(esc_kill, v.zeros((n0,), dev), beta)
            valid = (surf_ok & ~in_scat) | in_scat
            is_med = in_scat
        else:
            valid = surf_ok
            is_med = no
            in_scat = no

        esc_now = alive & ~it.valid & ~in_scat
        if i == 0:
            escape = dict(d=cur_d, beta=beta, pdf_dir=pdf_dir,
                          escaped=esc_now, delta=pdf_delta,
                          i=torch.where(esc_now, 0, -1))
        else:
            escape = dict(
                d=v.where(esc_now, cur_d, escape["d"]),
                beta=v.where(esc_now, beta, escape["beta"]),
                pdf_dir=torch.where(esc_now, pdf_dir, escape["pdf_dir"]),
                escaped=escape["escaped"] | esc_now,
                delta=torch.where(esc_now, pdf_delta, escape["delta"]),
                i=torch.where(esc_now, i, escape["i"]))

        if has_media:
            p_v = v.where(is_med, prev_p + cur_d * t_m, it.p)
            fr_m = v.frame_from_normal(-cur_d)
            ns_v = v.where(is_med, -cur_d, it.ns)
            ng_v = v.where(is_med, -cur_d, it.ng)
            ss_v = v.where(is_med, fr_m[0], it.ss)
            ts_v = v.where(is_med, fr_m[1], it.ts_)
        else:
            p_v, ns_v, ng_v, ss_v, ts_v = it.p, it.ns, it.ng, it.ss, it.ts_

        bparams = scene.bsdf_at_v(it)
        pdf_fwd = torch.where(
            pdf_delta, 0.0,
            _conv_density(scene, pdf_dir, prev_p, p_v, ns_v, is_med, mid,
                          has_media))
        if i == 0 and infinite0 is not None:
            # a parallel beam from the bounding disk: pdf_pos |cos|
            pdf_inf = pdf_dir * torch.abs(ns_v.dot(cur_d))
            pdf_fwd = torch.where(infinite0, pdf_inf, pdf_fwd)
        vx = dict(
            p=p_v, ns=ns_v, ng=ng_v, ss=ss_v, ts=ts_v,
            shape=torch.where(is_med, INVALID, it.shape),
            wi_local=it.wi_local, bp=bparams, beta=beta, pdf_fwd=pdf_fwd,
            pdf_rev=torch.zeros_like(pdf_fwd),
            delta=lane_is_delta(bparams) & ~is_med, valid=valid,
            emitter=torch.where(is_med, -1, scene.emitter_at_id(it.shape)),
            mid=mid, is_med=is_med, wi_world=-cur_d)
        if has_media:
            vx["ctx"] = med.phase_ctx_v(scene.media, mid, p_v)

        s, blk = mrng.next_block4_v(s)
        bs = bsdf_sample_v(bparams, it.wi_local, *blk)
        wo_surf = v.to_world((it.ss, it.ts_, it.ns), bs.wo)
        if has_media:
            wo_ph, pdf_ph, w_ph = med.phase_sample_ctx_v(
                scene.media, vx["ctx"], -cur_d, mblk[1], mblk[2], mblk[3])
            wo_world = v.where(is_med, wo_ph, wo_surf)
            pdf_out = torch.where(is_med, pdf_ph,
                                  torch.where(bs.delta, 0.0, bs.pdf))
            out_delta = bs.delta & ~is_med
            w_step = v.where(is_med, V3(w_ph, w_ph, w_ph), bs.weight)
        else:
            wo_world = wo_surf
            pdf_out = torch.where(bs.delta, 0.0, bs.pdf)
            out_delta = bs.delta
            w_step = bs.weight

        # reverse density of sampling the arrival direction given wo
        pdf_rev_sa = _vertex_pdf(scene, vx, wo_world, has_media,
                                 reverse=True)
        pdf_rev_sa = torch.where(out_delta, 0.0, pdf_rev_sa)
        prev_rev = _conv_density(scene, pdf_rev_sa, p_v, prev_p, prev_n,
                                 prev_is_med, mid, has_media)
        if i == 0:
            start_rev = prev_rev
            if infinite0 is not None:
                # toward an infinite origin the density stays per solid
                # angle
                start_rev = torch.where(infinite0, pdf_rev_sa, start_rev)
        else:
            verts[i - 1]["pdf_rev"] = torch.where(valid, prev_rev,
                                                  verts[i - 1]["pdf_rev"])

        beta = beta * w_step
        if adjoint:
            # importance transport: the shading-normal correction
            # (surfaces only)
            corr = _adjoint_correction(it.ns, it.ng, -cur_d, wo_world)
            corr = torch.where(is_med, 1.0, corr)
            beta = beta * torch.where(valid, corr, 1.0)
        pdf_dir = pdf_out
        pdf_delta = out_delta
        alive = valid & ((w_step.x.abs() + w_step.y.abs()
                          + w_step.z.abs()) > 0)
        if has_media:
            mid = torch.where(
                valid & ~is_med,
                _medium_transition_v(scene, it.shape, wo_world, it.ng, mid),
                mid)
        prev_p, prev_n = p_v, ns_v
        prev_is_med = is_med
        cur_d = wo_world
        verts.append(vx)

    if n_steps == 0:
        escape = dict(d=d, beta=beta0, pdf_dir=pdf_dir0, escaped=no,
                      delta=no, i=torch.full((n0,), -1, dtype=torch.int64,
                                             device=dev))
    return verts, s, escape, start_rev


def sample_light_origin(scene: Scene, u_sel, u_pos_a, u_pos_b, u_dir_a,
                        u_dir_b) -> dict:
    """The light subpath's origin with separated densities: pdf_fwd =
    select pmf x position pdf (area measure; an infinite emitter's
    direction pdf in solid angle), the emission direction and its density
    ``pdf_dir`` (an infinite emitter's: the disk's), and Le.  Lanes that
    select a collimated beam come back dead, not renormalized, so that the
    selection pmf in the MIS weights stays exact."""
    emt = scene.emitters
    shape, dev = u_sel.shape, u_sel.device
    eid, sel_pmf = em.select_emitter_v(emt, u_sel)
    etype = v.gather_row(emt.type, eid)

    p, n, d, le = (v.zeros(shape, dev) for _ in range(4))
    pdf_pos = torch.ones(shape, dtype=Float, device=dev)
    pdf_dir = torch.zeros(shape, dtype=Float, device=dev)
    no = torch.zeros(shape, dtype=torch.bool, device=dev)
    delta = alive = infinite = no

    r_w = emt.bsphere_radius * 1.05 + 1e-4
    c_w = V3(*(c.expand(shape) for c in emt.bsphere_center))
    disk_pdf = 1.0 / (PI * r_w * r_w)

    def disk_origin(d_prop: V3) -> V3:
        fr = v.frame_from_normal(d_prop)
        rr = torch.sqrt(torch.clamp_min(u_pos_a, 0.0)) * r_w
        ph = 2.0 * PI * u_pos_b
        off = V3(rr * torch.cos(ph), rr * torch.sin(ph), torch.zeros_like(rr))
        return c_w - d_prop * r_w + v.to_world(fr, off)

    for t in emt.used_types:
        sel = etype == t
        if t in (em.EM_ENVMAP, em.EM_CONSTANT, em.EM_DIRECTIONAL):
            if t == em.EM_ENVMAP:
                uu, vv, pdf_uv = emt.env_dist.sample_continuous(u_dir_a,
                                                                u_dir_b)
                w_esc = em._env_dir_from_uv_v(emt, uu, vv)
                sin_t = torch.clamp_min(torch.sin(vv * PI), 1e-6)
                pdir = pdf_uv / (2.0 * PI * PI * sin_t)
                rad = em._env_lookup_v(emt, uu, vv,
                                       v.gather_v3(emt.radiance, eid))
                is_delta = False
            elif t == em.EM_CONSTANT:
                w_esc = v.square_to_uniform_sphere(u_dir_a, u_dir_b)
                pdir = torch.full(shape, em.INV_FOURPI, dtype=Float,
                                  device=dev)
                rad = v.gather_v3(emt.radiance, eid)
                is_delta = False
            else:  # directional: a delta direction, irradiance payload
                w_esc = -v.gather_v3(emt.direction, eid)
                pdir = torch.ones(shape, dtype=Float, device=dev)
                rad = v.gather_v3(emt.intensity, eid)
                is_delta = True
            d_prop = -w_esc
            p = v.where(sel, disk_origin(d_prop), p)
            n, d = v.where(sel, d_prop, n), v.where(sel, d_prop, d)
            le = v.where(sel, rad, le)
            pdf_pos = torch.where(sel, pdir, pdf_pos)  # -> the pdf_fwd slot
            pdf_dir = torch.where(sel, disk_pdf, pdf_dir)  # step density
            if is_delta:
                delta = delta | sel
            infinite = infinite | sel
            alive = alive | sel
        elif t == em.EM_AREA:
            p_s, n_s, pdf_a = em._sample_area_position_v(
                emt, scene.geom, eid, u_pos_a, u_pos_b,
                v.gather_row(emt.total_area, eid))
            d_loc = v.square_to_cosine_hemisphere(u_dir_a, u_dir_b)
            d_s = v.to_world(v.frame_from_normal(n_s), d_loc)
            pdir = torch.clamp_min(d_loc.z, 0.0) / PI
            p, n, d = (v.where(sel, p_s, p), v.where(sel, n_s, n),
                       v.where(sel, d_s, d))
            le = v.where(sel, v.gather_v3(emt.radiance, eid), le)
            pdf_pos = torch.where(sel, pdf_a, pdf_pos)
            pdf_dir = torch.where(sel, pdir, pdf_dir)
            alive = alive | sel
        elif t in (em.EM_POINT, em.EM_SPOT):
            d_s = v.square_to_uniform_sphere(u_dir_a, u_dir_b)
            inten = v.gather_v3(emt.intensity, eid)
            if t == em.EM_SPOT:
                cd = d_s.dot(v.gather_v3(emt.direction, eid))
                cc = v.gather_row(emt.cos_cutoff, eid)
                cf = v.gather_row(emt.cos_falloff, eid)
                fall = torch.clamp(
                    (cd - cc) / torch.clamp_min(cf - cc, 1e-6), 0.0, 1.0)
                inten = inten * torch.where(cd > cc, fall, 0.0)
            p = v.where(sel, v.gather_v3(emt.position, eid), p)
            n, d = v.where(sel, d_s, n), v.where(sel, d_s, d)
            le = v.where(sel, inten, le)
            pdf_pos = torch.where(sel, 1.0, pdf_pos)
            pdf_dir = torch.where(sel, 1.0 / (4.0 * PI), pdf_dir)
            delta = delta | sel
            alive = alive | sel
        # collimated: a measure-zero beam, the lane stays dead

    return dict(p=p, ns=n, d=d, le=le, sel_pmf=sel_pmf, pdf_pos=pdf_pos,
                pdf_dir=pdf_dir, pdf_fwd=sel_pmf * pdf_pos, delta=delta,
                valid=alive, emitter=eid, infinite=infinite,
                pdf_rev=torch.zeros(shape, dtype=Float, device=dev))


def _emitter_rows(emt: em.EmitterTable, emitter_id):
    return torch.clamp(emitter_id, 0, emt.type.shape[0] - 1)


def pdf_light_origin(scene: Scene, emitter_id, valid_emitter):
    """Area density of a light origin at a given emitter point: select pmf
    x position pdf; 0 for other than area emitters, which no path hits by
    chance (the s = 0 strategies' alternative)."""
    emt = scene.emitters
    eid = _emitter_rows(emt, emitter_id)
    if emt.select_pmf.shape[0] == 1:
        pmf = torch.ones_like(eid, dtype=Float)
    else:
        pmf = v.gather_row(emt.select_pmf, eid)
    area = v.gather_row(emt.total_area, eid)
    is_area = v.gather_row(emt.type, eid) == em.EM_AREA
    ok = valid_emitter & is_area & (area > 0)
    return torch.where(ok, pmf / torch.clamp_min(area, 1e-20), 0.0)


def pdf_light_dir_area(scene: Scene, emitter_id, p_light: V3, n_light: V3,
                       p_next: V3, n_next: V3, valid, to_is_med=None,
                       seg_mid=None):
    """Area or volume density at ``p_next`` of the light emitting toward it
    (the cosine hemisphere of area lights, the uniform sphere of point and
    spot lights)."""
    emt = scene.emitters
    etype = v.gather_row(emt.type, _emitter_rows(emt, emitter_id))
    d = _dir(p_light, p_next)
    cos_l = n_light.dot(d)
    pdf_sa = torch.where(
        etype == em.EM_AREA, torch.clamp_min(cos_l, 0.0) / PI,
        torch.where((etype == em.EM_POINT) | (etype == em.EM_SPOT),
                    1.0 / (4.0 * PI), 0.0))
    if to_is_med is None:
        return torch.where(valid, _to_area(pdf_sa, p_light, p_next, n_next),
                           0.0)
    return torch.where(valid, _conv_density(
        scene, pdf_sa, p_light, p_next, n_next, to_is_med, seg_mid, True),
        0.0)


def camera_pdf_dir(scene: Scene, d_world: V3):
    """Solid-angle density of the camera sampling ``d_world`` under
    uniform film sampling, 1 / (A_img cos^3 theta)."""
    sensor = scene.sensor
    m = sensor.to_camera
    d_cam = V3(*(m[k, 0] * d_world.x + m[k, 1] * d_world.y
                 + m[k, 2] * d_world.z for k in range(3))).normalized()
    cos_t = torch.clamp_min(d_cam.z, 1e-6)
    a_img = 4.0 * sensor.tan_x * sensor.tan_y
    return 1.0 / (a_img * cos_t ** 3)


# ---------------------------------------------------------------------------
# MIS weight
# ---------------------------------------------------------------------------

def mis_weight(scene: Scene, light_vs: list, eye_vs: list, s: int, t: int,
               overrides: dict):
    """Balance-heuristic weight of strategy (s, t), PBRT's form.

    ``eye_vs[0]`` is the camera record and ``light_vs[0]`` the origin;
    ``overrides`` maps (side, index) to the pdf_rev that the connection
    replaces.  Every index is static."""
    if s + t == 2:
        return torch.ones_like(eye_vs[0]["p"].x)

    def rev(side, i, default):
        return overrides.get((side, i), default)

    sum_ri = 0.0
    ri = 1.0
    for i in range(t - 1, 0, -1):
        vx = eye_vs[i]
        ri = ri * _remap0(rev("eye", i, vx["pdf_rev"])) / _remap0(
            vx["pdf_fwd"])
        d_i = (vx["delta"] if "delta" in vx
               else torch.zeros_like(vx["pdf_fwd"], dtype=torch.bool))
        d_im1 = (eye_vs[i - 1]["delta"] if i - 1 >= 1
                 else torch.zeros_like(d_i))  # the camera is not delta
        sum_ri = sum_ri + torch.where(~d_i & ~d_im1, ri, 0.0)
    ri = 1.0
    for i in range(s - 1, -1, -1):
        vx = light_vs[i]
        ri = ri * _remap0(rev("light", i, vx["pdf_rev"])) / _remap0(
            vx["pdf_fwd"])
        d_i = vx["delta"]
        d_im1 = (light_vs[i - 1]["delta"] if i >= 1
                 else torch.zeros_like(d_i))  # nothing before the origin
        sum_ri = sum_ri + torch.where(~d_i & ~d_im1, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


# ---------------------------------------------------------------------------
# Strategy evaluation
# ---------------------------------------------------------------------------

def _seg_tr(scene: Scene, mid, o: V3, d: V3, dist, med_s):
    """Edge transmittance (the ``PathEdge`` analog): Beer-Lambert over
    ``dist`` in the lanes' medium ``mid``, ratio-tracked on grid lanes with
    the edges' own stream ``med_s``.  Returns (tr V3, med_s)."""
    _ss, st, _pt, _g = med.medium_params_v(scene.media, mid)
    tr = med.transmittance_v(st, dist)
    if scene.media.has_hetero:
        rows = med.hetero_rows_v(scene.media, mid)
        med_s, T = med.track_transmittance_v(scene.media, rows, o, d, dist,
                                             med_s, rows["is_het"])
        tr = v.where(rows["is_het"], V3(T, T, T), tr)
    return tr, med_s


def _occluded_seg(scene: Scene, a: V3, b: V3):
    dist = torch.sqrt(torch.clamp_min(_dist2(a, b), 1e-20))
    d = (b - a) / dist
    return (scene.occluded_v(a, d, EPSILON, dist * (1.0 - SHADOW_EPSILON)),
            d, dist)


def _infinite_types(etype):
    return ((etype == em.EM_ENVMAP) | (etype == em.EM_CONSTANT)
            | (etype == em.EM_DIRECTIONAL))


def bdpt_sample(scene: Scene, sampler: mrng.Sampler3, o_cam: V3, d_cam: V3,
                max_depth: int, hide_emitters: bool = False):
    """Evaluate every strategy for a wavefront of camera samples.

    Returns (li V3, the same pixel's radiance; the t = 1 splats, a list of
    (u, v, value V3) in the film's [0, 1) coordinates, one per light
    vertex that fits the depth)."""
    n = o_cam.x.shape[0]
    dev = o_cam.x.device
    s = sampler
    has_media = scene.media.any
    zf = torch.zeros((n,), dtype=Float, device=dev)
    no = torch.zeros((n,), dtype=torch.bool, device=dev)
    zeros = v.zeros((n,), dev)

    # the camera and the lights sit in the camera's medium
    medium0 = (torch.full((n,), scene.camera_medium, dtype=Int, device=dev)
               if has_media else None)
    med_s = None
    if has_media:
        med_s = mrng.make_sampler_v(
            s.pixel, s.sample if s.sample_index is None else s.sample_index,
            s.seed ^ MED_SEED)

    # --- eye subpath -------------------------------------------------------
    cam_v = dict(p=o_cam, pdf_fwd=torch.ones((n,), dtype=Float, device=dev),
                 pdf_rev=zf)
    eye_vs, s, esc, _ = random_walk(
        scene, s, o_cam, d_cam, v.ones((n,), dev), camera_pdf_dir(scene,
                                                                  d_cam),
        max_depth, o_cam, d_cam, medium0=medium0)

    # --- light subpath -----------------------------------------------------
    s, lblk = mrng.next_block4_v(s)
    s, lblk2 = mrng.next_block4_v(s)
    lv0 = sample_light_origin(scene, lblk[0], lblk[1], lblk[2], lblk2[0],
                              lblk2[1])
    cos0 = torch.where(lv0["delta"], 1.0, torch.abs(lv0["ns"].dot(lv0["d"])))
    beta_l = lv0["le"] * (cos0 / torch.clamp_min(
        lv0["pdf_fwd"] * lv0["pdf_dir"], 1e-20))
    beta_l = v.where(lv0["valid"], beta_l, zeros)
    light_tail, s, _lesc, l0_rev = random_walk(
        scene, s, lv0["p"], lv0["d"], beta_l, lv0["pdf_dir"],
        max(max_depth - 1, 0), lv0["p"], lv0["ns"], adjoint=True,
        infinite0=lv0["infinite"], medium0=medium0)
    lv0.update(pdf_rev=l0_rev, mid=medium0, is_med=no, wi_world=lv0["d"])
    light_vs = [lv0] + light_tail
    # a light vertex counts only if its whole prefix is valid
    pref = lv0["valid"]
    for vx in light_tail:
        pref = pref & vx["valid"]
        vx["valid"] = pref

    emt = scene.emitters
    li = zeros
    splats = []
    T = len(eye_vs)
    S = len(light_vs)
    r_w = emt.bsphere_radius * 1.05 + 1e-4
    disk_pdf = 1.0 / (PI * r_w * r_w)

    # --- s = 0: the eye path hits an emitter -------------------------------
    for ti in range(T):
        vx = eye_vs[ti]
        if ti == 0 and hide_emitters:
            continue
        has_em = vx["valid"] & (vx["emitter"] >= 0)
        prev_p = o_cam if ti == 0 else eye_vs[ti - 1]["p"]
        le = em.emitted_radiance_v(emt, vx["emitter"], vx["ns"],
                                   _dir(vx["p"], prev_p))
        overrides = {("eye", ti + 1): pdf_light_origin(scene, vx["emitter"],
                                                       has_em)}
        if ti >= 1:
            pm = eye_vs[ti - 1]
            overrides[("eye", ti)] = pdf_light_dir_area(
                scene, vx["emitter"], vx["p"], vx["ns"], pm["p"], pm["ns"],
                has_em, to_is_med=pm["is_med"] if has_media else None,
                seg_mid=vx["mid"])
        w = mis_weight(scene, [], [cam_v] + eye_vs[:ti + 1], 0, ti + 2,
                       overrides)
        li = li + v.where(has_em, vx["beta"] * le * w, zeros)

    # --- the environment escape: s = 0 with a pseudo-vertex at infinity ----
    if emt.env_index >= 0 or em.EM_CONSTANT in emt.used_types:
        env_val = em.eval_environment_v(emt, esc["d"])
        env_pdf = em.pdf_direct_env_v(emt, esc["d"])
        for ti in range(T + 1):
            mask = esc["escaped"] & (esc["i"] == ti)
            if ti == 0:
                # a primary escape: the one strategy
                if not hide_emitters:
                    li = li + v.where(mask, esc["beta"] * env_val, zeros)
                continue
            env_v = dict(p=eye_vs[ti - 1]["p"],
                         pdf_fwd=torch.where(esc["delta"], 0.0,
                                             esc["pdf_dir"]),
                         pdf_rev=env_pdf, delta=esc["delta"], valid=mask)
            prev = eye_vs[ti - 1]
            overrides = {("eye", ti): torch.where(
                mask, disk_pdf * torch.abs(prev["ns"].dot(esc["d"])),
                prev["pdf_rev"])}
            w = mis_weight(scene, [], [cam_v] + eye_vs[:ti] + [env_v], 0,
                           ti + 2, overrides)
            w = torch.where(esc["delta"], 1.0, w)
            li = li + v.where(mask, esc["beta"] * env_val * w, zeros)

    # --- s = 1: NEE from each eye vertex -----------------------------------
    for ti in range(T):
        if ti + 2 > max_depth:
            break
        vx = eye_vs[ti]
        s, blk = mrng.next_block4_v(s)
        ds = em.sample_direct_v(emt, scene.geom, vx["p"], blk[0], blk[1],
                                blk[2])
        f = _vertex_f(scene, vx, ds.d, has_media)
        occ = scene.occluded_v(vx["p"], ds.d, EPSILON,
                               ds.dist * (1.0 - SHADOW_EPSILON))
        ok = vx["valid"] & (ds.pdf > 0) & ~occ
        contrib = vx["beta"] * ds.value * f / torch.clamp_min(ds.pdf, 1e-20)
        if has_media:
            tr_e, med_s = _seg_tr(scene, vx["mid"], vx["p"], ds.d, ds.dist,
                                  med_s)
            contrib = contrib * tr_e

        q_p = vx["p"] + ds.d * ds.dist
        cos_q = torch.abs(ds.n.dot(-ds.d))
        inf_q = _infinite_types(v.gather_row(emt.type,
                                             _emitter_rows(emt, ds.emitter)))
        q_fwd = torch.where(ds.delta, ds.pdf, ds.pdf * cos_q
                            / torch.clamp_min(ds.dist ** 2, 1e-20))
        # infinite emitters: the solid-angle measure at the pseudo-vertex
        q_fwd = torch.where(inf_q & ~ds.delta, ds.pdf, q_fwd)
        bsdf_rev_sa = _vertex_pdf(scene, vx, ds.d, has_media)
        if has_media:
            q_rev = _conv_density(scene, bsdf_rev_sa, vx["p"], q_p, ds.n,
                                  no, vx["mid"], True)
        else:
            q_rev = _to_area(bsdf_rev_sa, vx["p"], q_p, ds.n)
        q_rev = torch.where(inf_q, bsdf_rev_sa, q_rev)
        q_v = dict(p=q_p, ns=ds.n, pdf_fwd=q_fwd, pdf_rev=q_rev,
                   delta=ds.delta, valid=ok, emitter=ds.emitter)
        overrides = {("eye", ti + 1): torch.where(
            inf_q, disk_pdf * torch.abs(vx["ns"].dot(ds.d)),
            pdf_light_dir_area(
                scene, ds.emitter, q_p, ds.n, vx["p"], vx["ns"], ok,
                to_is_med=vx["is_med"] if has_media else None,
                seg_mid=vx["mid"]))}
        if ti >= 1:
            pm = eye_vs[ti - 1]
            rev_sa = _vertex_pdf(scene, vx, ds.d, has_media, reverse=True)
            if has_media:
                overrides[("eye", ti)] = _conv_density(
                    scene, rev_sa, vx["p"], pm["p"], pm["ns"], pm["is_med"],
                    pm["mid"], True)
            else:
                overrides[("eye", ti)] = _to_area(rev_sa, vx["p"], pm["p"],
                                                  pm["ns"])
        w = mis_weight(scene, [q_v], [cam_v] + eye_vs[:ti + 1], 1, ti + 2,
                       overrides)
        li = li + v.where(ok, contrib * w, zeros)

    # --- t = 1: light tracing to the camera --------------------------------
    for si in range(1, S):
        if si + 1 > max_depth:
            break
        vx = light_vs[si]
        u, uv_v, cam_p, dist, imp, vis = connect_v(scene.sensor, vx["p"])
        d_vc = _dir(vx["p"], cam_p)
        f = _vertex_f(scene, vx, d_vc, has_media, adjoint=True)
        occ = scene.occluded_v(vx["p"], d_vc, EPSILON,
                               dist * (1.0 - SHADOW_EPSILON))
        ok = vx["valid"] & vis & ~occ
        val = vx["beta"] * f * (imp / torch.clamp_min(dist * dist, 1e-20))
        if has_media:
            tr_e, med_s = _seg_tr(scene, vx["mid"], vx["p"], d_vc, dist,
                                  med_s)
            val = val * tr_e

        rev_sa = _vertex_pdf(scene, vx, d_vc, has_media, reverse=True)
        pv_l = light_vs[si - 1]
        if has_media:
            rev_prev = _conv_density(scene, rev_sa, vx["p"], pv_l["p"],
                                     pv_l["ns"], pv_l["is_med"], vx["mid"],
                                     True)
            cam_conv = _conv_density(scene, camera_pdf_dir(scene, -d_vc),
                                     cam_p, vx["p"], vx["ns"], vx["is_med"],
                                     vx["mid"], True)
        else:
            rev_prev = _to_area(rev_sa, vx["p"], pv_l["p"], pv_l["ns"])
            cam_conv = _to_area(camera_pdf_dir(scene, -d_vc), cam_p,
                                vx["p"], vx["ns"])
        if si == 1:
            rev_prev = torch.where(lv0["infinite"], rev_sa, rev_prev)
        w = mis_weight(scene, light_vs[:si + 1], [cam_v], si + 1, 1,
                       {("light", si): cam_conv, ("light", si - 1): rev_prev})
        splats.append((u, uv_v, v.where(ok, val * w, zeros)))

    # --- s >= 2, t >= 2: inner connections ---------------------------------
    def conv(pdf_sa, from_p, to_v, seg_mid):
        if has_media:
            return _conv_density(scene, pdf_sa, from_p, to_v["p"],
                                 to_v["ns"], to_v["is_med"], seg_mid, True)
        return _to_area(pdf_sa, from_p, to_v["p"], to_v["ns"])

    for si in range(1, S):
        for ti in range(T):
            if si + ti + 2 > max_depth:
                continue
            vq = light_vs[si]
            vp = eye_vs[ti]
            ok0 = vq["valid"] & vp["valid"]
            occ, d_pq, dist = _occluded_seg(scene, vp["p"], vq["p"])
            f_p = _vertex_f(scene, vp, d_pq, has_media)
            f_q = _vertex_f(scene, vq, -d_pq, has_media, adjoint=True)
            ok = ok0 & ~occ
            contrib = vp["beta"] * vq["beta"] * f_p * f_q / torch.clamp_min(
                dist * dist, 1e-20)
            if has_media:
                tr_e, med_s = _seg_tr(scene, vp["mid"], vp["p"], d_pq, dist,
                                      med_s)
                contrib = contrib * tr_e

            rev_q_sa = _vertex_pdf(scene, vq, -d_pq, has_media, reverse=True)
            rev_prev_q = conv(rev_q_sa, vq["p"], light_vs[si - 1],
                              vq["mid"] if has_media else None)
            if si == 1:
                rev_prev_q = torch.where(lv0["infinite"], rev_q_sa,
                                         rev_prev_q)
            overrides = {
                ("eye", ti + 1): conv(_vertex_pdf(scene, vq, -d_pq,
                                                  has_media),
                                      vq["p"], vp,
                                      vp["mid"] if has_media else None),
                ("light", si): conv(_vertex_pdf(scene, vp, d_pq, has_media),
                                    vp["p"], vq,
                                    vp["mid"] if has_media else None),
                ("light", si - 1): rev_prev_q,
            }
            if ti >= 1:
                pm = eye_vs[ti - 1]
                overrides[("eye", ti)] = conv(
                    _vertex_pdf(scene, vp, d_pq, has_media, reverse=True),
                    vp["p"], pm, pm["mid"] if has_media else None)
            w = mis_weight(scene, light_vs[:si + 1],
                           [cam_v] + eye_vs[:ti + 1], si + 1, ti + 2,
                           overrides)
            li = li + v.where(ok, contrib * w, zeros)

    return li, splats


# ---------------------------------------------------------------------------
# Render loop
# ---------------------------------------------------------------------------

def _finite(c: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0)


def bdpt_pass(scene: Scene, film, light_img: torch.Tensor, sample_idx: int,
              seed: int, max_depth: int, hide_emitters: bool,
              light_image: bool):
    """One sample per pixel: the camera rays of the independent sampler,
    every strategy, ``li`` splatted into the box ``film`` at the pixel and
    the t = 1 splats summed into ``light_img`` (H, W, 3) at theirs."""
    W, H = film.width, film.height
    pix = torch.arange(W * H, dtype=torch.int64, device=scene.device)
    sampler = mrng.make_sampler_v(pix, sample_idx, seed)
    sampler, blk0 = mrng.next_block4_v(sampler)
    px = (pix % W).to(Float) + blk0[0]
    py = (pix // W).to(Float) + blk0[1]
    o, d, _w = sample_ray_v(scene.sensor, px / W, py / H, blk0[2], blk0[3])

    li, splats = bdpt_sample(scene, sampler, o, d, max_depth, hide_emitters)
    film = film_splat(film, px, py, V3(*(_finite(c) for c in li)))

    if light_image and splats:
        su = torch.cat([sp[0] for sp in splats]) * W
        sv = torch.cat([sp[1] for sp in splats]) * H
        vals = torch.stack([_finite(torch.cat([sp[2][k] for sp in splats]))
                            for k in range(3)], dim=-1)
        sx = torch.clamp(su.to(Int), 0, W - 1)
        sy = torch.clamp(sv.to(Int), 0, H - 1)
        idx = spread_inactive(sy * W + sx, (vals != 0).any(-1), W * H)
        light_img.view(-1, 3).index_put_((idx,), vals, accumulate=True)
    return film, light_img


def render_bdpt(scene: Scene, settings, spp: int | None = None,
                progress_cb=None) -> torch.Tensor:
    """The bidirectional image, (H, W, 3) on the scene's device: the box
    film's average plus the light image over spp (``render_bdpt``);
    ``max_depth`` -1 means 6.  ``progress_cb(done, spp, film)`` runs after
    each pass."""
    ip = settings.integrator_props
    W, H = settings.width, settings.height
    spp = spp if spp is not None else settings.spp
    md = ip.get("max_depth", -1)
    max_depth = md if md > 0 else 6
    hide = bool(ip.get("hide_emitters", False))
    light_image = bool(ip.get("light_image", True))

    film = make_film(W, H, F_BOX, 0.5, device=scene.device)
    light_img = torch.zeros((H, W, 3), dtype=Float, device=scene.device)
    with torch.no_grad():
        for si in range(spp):
            film, light_img = bdpt_pass(scene, film, light_img, si,
                                        settings.seed, max_depth, hide,
                                        light_image)
            if progress_cb is not None:
                progress_cb(si + 1, spp, film)
    w = film.data[..., 3:4]
    base = torch.where(w > 0, film.data[..., :3] / torch.clamp_min(w, 1e-12),
                       0.0)
    return base + light_img / spp
