"""Stochastic progressive photon mapping, also for the ``ppm`` and
``photonmapper`` names (``mitsuba_im_tpu/integrators/sppm.py``).

Each pass traces one camera ray per pixel through delta chains to its
first smooth vertex (:func:`eye_pass`), traces ``n_photons`` light paths
that deposit a photon at every smooth surface vertex
(:func:`photon_trace`), sorts the photons into a spatial hash grid
(:func:`build_grid`) and gathers, at every pixel's vertex, the photons
within the pixel's radius from the 27 neighbouring cells, at most ``cap``
of each cell (:func:`gather`).  Hachisuka's update then shrinks each
pixel's radius: with alpha in (0, 1), N' = N + alpha M, R'^2 = R^2 N' /
(N + M), tau' = (tau + sum f phi / n_photons) R'^2 / R^2; the image is
tau / (passes pi R^2) plus the light seen along the delta chains, averaged
over the passes.  Scenes with scattering media also deposit volume photons
at free-flight events and add a beam radiance estimate along each camera
ray's first segment (:func:`beam_gather`).

The grid is the reference's: cells of the initial radius, each cell's
integer coordinates hashed (:func:`_cell_hash`, uint32 arithmetic in int64
words masked to 32 bits, as ``core/rng.py`` does) into 2^18 - 1 buckets,
invalid photons in the sentinel bucket 2^18 - 1, the photons sorted by the
key (bucket << 12 | 12 bits of a per-photon hash) with a stable argsort,
and each query cell's run found by ``searchsorted``.  A run longer than
``cap`` is scanned for its first ``cap`` photons (a uniform subsample, by
the hashed low key bits) and each found photon counts full / cap.

The reference's gather is a loop of 27 x ``cap`` steps, each evaluating
the BSDF over every pixel.  The port expands, for a chunk of pixels, the
(pixel, cell, slot) pairs that exist (the runs' lengths), in the
reference's order (pixel, then cell, then slot), tests their distances,
keeps the pairs within the radius, evaluates the BSDF on those alone, and
sums them per pixel with ``index_put_(accumulate=True)``: the reference's
sums in its order on the CPU, deterministic on the card.  A chunk holds
at most about ``PAIR_CHUNK`` pairs, which bounds the peak memory; the
device operations of a gather are ~60 a chunk.  :data:`GATHER_STATS`
counts the chunks, pairs and kept pairs.

Phase functions (ROADMAP C16): the reference samples the volume photons'
continuation through ``media/medium.py::phase_sample`` and weighs the beam
estimate with ``phase_eval``, which know isotropic, HG and Rayleigh only
and give every other phase the isotropic lobe.  The port goes through its
phase context (``phase_ctx_v``, ``phase_sample_ctx_v``,
``phase_eval_ctx_v``): the mixture's pick is the medium block's fourth
draw, which the reference leaves unused, and a structured phase's sampling
weight multiplies the photon's power.  On isotropic, HG and Rayleigh media
the draws and values are the reference's.

The eye pass takes the primary segment's transmittance in the camera's
medium and walks delta chains without attenuation, as the reference does
(volpath carries the rest; documented there).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.types import Float
from ..core import v3 as v
from ..core.v3 import V3
from ..core import rng as mrng
from ..bsdf.common import LaneParams3, lane_is_delta
from ..bsdf.eval import bsdf_eval_v, bsdf_sample_v
from ..emitter import table as em
from ..media import medium as med
from ..scene.scene import Scene
from ..sensor.table import sample_ray_v
from .bdpt import _seg_sigma
from .path import _fake_it_v
from .ptracer import sample_emitter_ray_v
from .volpath import _medium_transition_v

HASH_BITS = 18  # 262,144 buckets
SENTINEL = (1 << HASH_BITS) - 1  # the invalid photons' bucket
PAIR_CHUNK = 1 << 24  # (query, photon) pairs expanded at once
NO_EVENT = 3e37
PHOTON_SEED = 0x5F3759DF
BEAM_SEED = 0xBEA11BEA
BEAM_STEPS = 24
# the 27 neighbour cells, dx fastest (the reference's order)
_OFFS = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
         for dx in (-1, 0, 1)]

GATHER_STATS = dict(chunks=0, pairs=0, kept=0)


def reset_gather_stats():
    for k in GATHER_STATS:
        GATHER_STATS[k] = 0


def _cell_hash(cx, cy, cz):
    """Integer cell coordinates (int64 tensors holding int32 values) ->
    hash bucket in [0, 2^18 - 2] (the reference's 3-word mix in uint32)."""
    x = ((cx & mrng.MASK32) * 73856093) & mrng.MASK32
    y = ((cy & mrng.MASK32) * 19349663) & mrng.MASK32
    z = ((cz & mrng.MASK32) * 83492791) & mrng.MASK32
    return (x ^ y ^ z) % SENTINEL


def _cells(p: V3, cell: torch.Tensor):
    """floor(p / cell) as int32 values in int64 words (``cell`` a 0-d
    float32 tensor on p's device, so that the division is elementwise)."""
    return tuple(torch.floor(c / cell).to(torch.int32).to(torch.int64)
                 for c in p)


def cell_tensor(cell, device) -> torch.Tensor:
    """A cell size as the 0-d float32 device tensor the grid divides by."""
    return torch.tensor(float(np.float32(cell)), dtype=Float, device=device)


def build_grid(p: V3, valid: torch.Tensor, cell: torch.Tensor):
    """Sort-based hash grid: (order, bucket_sorted), the photon indices
    sorted by bucket (randomized within a bucket) and the sorted buckets;
    invalid photons sort into the sentinel bucket, which no query meets."""
    b = _cell_hash(*_cells(p, cell))
    b = torch.where(valid, b, SENTINEL)
    m = b.shape[0]
    r12 = mrng.hash_u32(torch.arange(m, dtype=torch.int64, device=b.device),
                        b) & 0xFFF
    order = torch.argsort((b << 12) | r12, stable=True)
    return order, b[order]


def neighbour_runs(bucket_sorted, x: V3, cell, cap: int):
    """(starts, runs, fulls), each (Q, 27): the sorted range of each query
    point's 27 neighbour cells, its length capped at ``cap``, and its full
    length."""
    cx, cy, cz = _cells(x, cell)
    off = torch.tensor(_OFFS, dtype=torch.int64, device=cx.device)
    b = _cell_hash(cx[:, None] + off[:, 0], cy[:, None] + off[:, 1],
                   cz[:, None] + off[:, 2])
    starts = torch.searchsorted(bucket_sorted, b, side="left")
    fulls = torch.searchsorted(bucket_sorted, b, side="right") - starts
    return starts, torch.clamp_max(fulls, cap), fulls


def pair_chunks(starts, runs, chunk: int = PAIR_CHUNK):
    """Yield (q, ci, idx) for chunks of the (query, cell, slot) pairs that
    exist, in query, then cell, then slot order: the query, its cell's
    index in 0..26 and the position ``starts[q, ci] + slot`` in the sorted
    grid.  A chunk holds about ``chunk`` pairs (at most chunk + 27 cap)."""
    nq, nc = runs.shape
    dev = runs.device
    if nq == 0:
        return
    cs = torch.cumsum(runs.sum(1), 0)
    total = int(cs[-1])
    if total == 0:
        return
    marks = torch.arange(1, (total + chunk - 1) // chunk + 1, device=dev,
                         dtype=torch.int64) * chunk
    bounds = torch.clamp_max(torch.searchsorted(cs, marks, right=True), nq)
    ends = cs[bounds - 1]
    q0, done = 0, 0
    for q1, end in zip(bounds.tolist(), ends.tolist()):
        if q1 <= q0:
            continue
        n = end - done
        r = runs[q0:q1].reshape(-1)
        e = torch.repeat_interleave(
            torch.arange(r.numel(), device=dev), r, output_size=n)
        first = torch.cumsum(r, 0) - r
        slot = torch.arange(n, device=dev) - first[e]
        GATHER_STATS["chunks"] += 1
        GATHER_STATS["pairs"] += n
        yield (q0 + e // nc, e % nc,
               starts[q0:q1].reshape(-1)[e] + slot)
        q0, done = q1, end


def index_params(bp: LaneParams3, idx: torch.Tensor) -> LaneParams3:
    """The BSDF parameters of lanes ``idx``."""
    def take(x):
        if isinstance(x, V3):
            return V3(*(c[idx] for c in x))
        if isinstance(x, torch.Tensor):
            return x[idx]
        return x
    return dataclasses.replace(bp, **{
        f.name: take(getattr(bp, f.name)) for f in dataclasses.fields(bp)})


def _take(x: V3, idx) -> V3:
    return V3(*(c[idx] for c in x))


def _d2(a: V3, qa, b: V3, qb):
    dx, dy, dz = (a[k][qa] - b[k][qb] for k in range(3))
    return dx * dx + dy * dy + dz * dz


def gather(p_ph: V3, power: V3, wi_ph: V3, order, bucket_sorted, x: V3,
           frame, wi_local_eye: V3, bparams: LaneParams3, r2, cell,
           cap: int, active=None):
    """Density estimate at eye vertices x: (sum f(wi_eye, wo_photon) phi
    over the photons within sqrt(r2), the found count), scanning 27
    neighbour cells of at most ``cap`` photons each, a capped run's photons
    weighted full / cap; ``frame`` the vertices' (ss, ts, ns).  Lanes
    outside ``active`` (where given) scan nothing and find 0."""
    n = x.x.shape[0]
    starts, runs, fulls = neighbour_runs(bucket_sorted, x, cell, cap)
    if active is not None:
        runs = torch.where(active[:, None], runs, 0)
    over = fulls.to(Float) / torch.clamp_min(runs.to(Float), 1.0)
    out = torch.zeros((n, 4), dtype=Float, device=x.x.device)
    for q, ci, idx in pair_chunks(starts, runs):
        pid = order[idx]
        sel = torch.nonzero(_d2(x, q, p_ph, pid) <= r2[q]).squeeze(1)
        q, ci, pid = q[sel], ci[sel], pid[sel]
        GATHER_STATS["kept"] += int(sel.numel())
        fr = tuple(_take(f, q) for f in frame)
        wo_local = v.to_local(fr, _take(wi_ph, pid))
        f = bsdf_eval_v(index_params(bparams, q), _take(wi_local_eye, q),
                        wo_local)
        # bsdf_eval folds in |cos wo|; the density estimate wants the BSDF
        f = f / torch.clamp_min(torch.abs(wo_local.z), 1e-6)
        o = over[q, ci]
        c = f * _take(power, pid) * o
        out.index_put_((q,), torch.stack([c.x, c.y, c.z, o], 1),
                       accumulate=True)
    return V3(out[:, 0], out[:, 1], out[:, 2]), out[:, 3]


def photon_trace(scene: Scene, sampler: mrng.Sampler3, max_bounces: int,
                 rr_depth: int = 5, want_surface: bool = False,
                 want_volume: bool = False):
    """Trace one light path per lane, depositing a photon at every smooth
    surface vertex; returns (p, power, wi, valid) of n x max_bounces
    photons, bounce-major (wi toward the light, power per emitted path),
    then with ``want_surface`` a dict of the deposits' surfaces (ns, ss,
    ts, uv_u, uv_v, shape, wi_local), so that they can serve as virtual
    point lights, then with ``want_volume`` the volume photons (p, power
    without sigma_s, wi, valid) of a scene with media (one invalid photon
    otherwise).

    The draws are the reference's: two light blocks, then per bounce a
    medium block (media only: the free flight, then the phase sample and
    the mixture's pick), a BSDF block and a Russian-roulette block."""
    has_vol = want_volume and scene.media.any
    s, blk = mrng.next_block4_v(sampler)
    s, blk2 = mrng.next_block4_v(s)
    ls = sample_emitter_ray_v(scene, blk[0], blk[1], blk[2], blk2[0],
                              blk2[1])
    n = ls.p.x.shape[0]
    dev = ls.p.x.device
    zeros = v.zeros((n,), dev)
    no = torch.zeros((n,), dtype=torch.bool, device=dev)

    ps, powers, wis, valids = [], [], [], []
    vps, vpows, vwis, vvalids = [], [], [], []
    surf = {k: [] for k in ("ns", "ss", "ts", "uv_u", "uv_v", "shape",
                            "wi_local")}

    prev_p, cur_d, thr = ls.p, ls.d, ls.weight
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    mid = (torch.full((n,), scene.camera_medium, dtype=torch.int32,
                      device=dev) if has_vol else None)

    for depth in range(1, max_bounces + 1):
        hit = scene.ray_intersect_v(prev_p, cur_d)
        it = scene.interaction_v(prev_p, cur_d, hit)

        in_scat = no
        if has_vol:
            s, mblk = mrng.next_block4_v(s)
            ss_m, st_m, _pt, _g = med.medium_params_v(scene.media, mid)
            sbar = _seg_sigma(scene, mid)
            t_m = torch.where(
                sbar > 0,
                -torch.log(torch.clamp_min(1.0 - mblk[0], 1e-20))
                / torch.clamp_min(sbar, 1e-20), NO_EVENT)
            t_surf = torch.where(it.valid, hit.t, NO_EVENT)
            in_scat = alive & (sbar > 0) & (t_m < t_surf)
            t_fin = torch.where(in_scat, t_m, t_surf)
            tr_full = med.transmittance_v(st_m, torch.clamp_max(t_fin, 1e30))
            pdf_t = torch.clamp_min(sbar, 1e-20) * torch.exp(-sbar * t_m)
            p_srf = torch.clamp_min(
                torch.exp(-sbar * torch.clamp_max(t_surf, 1e30)), 1e-20)
            # the volume deposit: the flux arriving at the event (no sigma_s)
            phi_v = thr * tr_full / pdf_t
            p_med = prev_p + cur_d * torch.where(in_scat, t_m, 0.0)
            vps.append(p_med)
            vpows.append(v.where(in_scat, phi_v, zeros))
            vwis.append(-cur_d)
            vvalids.append(in_scat)
            w_med = tr_full * (ss_m / pdf_t)
            w_srf = tr_full / p_srf
            thr = thr * v.where(in_scat, w_med, w_srf)
            surf_ok = alive & it.valid & ~in_scat
        else:
            surf_ok = alive & it.valid

        bparams = scene.bsdf_at_v(it)
        # delta surfaces store no flux
        smooth = surf_ok & ~lane_is_delta(bparams)
        ps.append(it.p)
        powers.append(v.where(smooth, thr, zeros))
        wis.append(-cur_d)
        valids.append(smooth)
        if want_surface:
            for k, val in (("ns", it.ns), ("ss", it.ss), ("ts", it.ts_),
                           ("uv_u", it.uv_u), ("uv_v", it.uv_v),
                           ("shape", it.shape), ("wi_local", it.wi_local)):
                surf[k].append(val)

        s, bsdf_blk = mrng.next_block4_v(s)
        bs = bsdf_sample_v(bparams, it.wi_local, *bsdf_blk)
        wo_world = v.to_world((it.ss, it.ts_, it.ns), bs.wo)
        w_step = bs.weight
        next_p = it.p
        if has_vol:
            ctx = med.phase_ctx_v(scene.media, mid, p_med)
            wo_ph, _pdf, w_ph = med.phase_sample_ctx_v(
                scene.media, ctx, -cur_d, mblk[1], mblk[2], mblk[3])
            wo_world = v.where(in_scat, wo_ph, wo_world)
            w_step = v.where(in_scat, V3(w_ph, w_ph, w_ph), w_step)
            next_p = v.where(in_scat, p_med, next_p)
        thr = thr * w_step
        act = (surf_ok | in_scat) & (thr.sum() > 0)

        s, rr_blk = mrng.next_block4_v(s)
        if depth >= rr_depth:
            q = torch.clamp_max(thr.max_c(), 0.95)
            kill = rr_blk[0] >= q
            thr = v.where(~kill, thr / torch.clamp_min(q, 1e-6), thr)
            act = act & ~kill
        alive = act
        if has_vol:
            mid = torch.where(
                surf_ok,
                _medium_transition_v(scene, it.shape, wo_world, it.ng, mid),
                mid)
        prev_p, cur_d = next_p, wo_world

    def cat3(xs):
        return V3(*(torch.cat([x[k] for x in xs]) for k in range(3)))

    out = (cat3(ps), cat3(powers), cat3(wis), torch.cat(valids))
    if want_surface:
        out = out + ({k: (cat3(val) if isinstance(val[0], V3)
                          else torch.cat(val)) for k, val in surf.items()},)
    if want_volume:
        if has_vol:
            vol = (cat3(vps), cat3(vpows), cat3(vwis), torch.cat(vvalids))
        else:
            z = v.zeros((1,), dev)
            vol = (z, z, z, torch.zeros((1,), dtype=torch.bool, device=dev))
        out = out + (vol,)
    return out


def beam_gather(scene: Scene, vp: V3, vpow: V3, vwi: V3, order_v,
                bsorted_v, o: V3, d: V3, t_seg, mid, cell_v, cap: int,
                n_steps: int, u_jit):
    """Beam radiance estimate along the camera rays' first segments in a
    homogeneous medium (``photonmapper/bre.cpp``): ``n_steps`` jittered
    points a ray, each gathering the volume photons of its 27 neighbour
    cells with a 3D Epanechnikov kernel of radius ``cell_v``, weighted by
    the phase function toward the camera (through the port's phase
    context, C16), transmittance, sigma_s and the step."""
    n = o.x.shape[0]
    dev = o.x.device
    ss_m, st_m, _pt, _g = med.medium_params_v(scene.media, mid)
    in_med = ss_m.mean() > 0
    big_t = torch.where(in_med, torch.clamp_max(t_seg, 1e4), 0.0)
    dt = big_t / n_steps
    r2v = cell_v * cell_v
    kern_c = 15.0 / (8.0 * math.pi * r2v * cell_v)

    # every step's point is a query, step-major
    t_k = torch.cat([(k + u_jit) * dt for k in range(n_steps)])
    lane = torch.arange(n, device=dev).repeat(n_steps)
    x = _take(o, lane) + _take(d, lane) * t_k
    starts, runs, fulls = neighbour_runs(bsorted_v, x, cell_v, cap)
    over = fulls.to(Float) / torch.clamp_min(runs.to(Float), 1.0)
    sums = torch.zeros((n_steps * n, 3), dtype=Float, device=dev)
    for q, ci, idx in pair_chunks(starts, runs):
        pid = order_v[idx]
        d2 = _d2(x, q, vp, pid)
        sel = torch.nonzero(d2 <= r2v).squeeze(1)
        q, ci, pid, d2 = q[sel], ci[sel], pid[sel], d2[sel]
        GATHER_STATS["kept"] += int(sel.numel())
        kern = kern_c * (1.0 - d2 / torch.clamp_min(r2v, 1e-20))
        ln = lane[q]
        ctx = med.phase_ctx_v(scene.media, mid[ln], _take(x, q))
        ph = med.phase_eval_ctx_v(scene.media, ctx, _take(vwi, pid),
                                  -_take(d, ln))
        c = _take(vpow, pid) * (ph * kern * over[q, ci])
        sums.index_put_((q,), torch.stack([c.x, c.y, c.z], 1),
                        accumulate=True)
    acc = v.zeros((n,), dev)
    for k in range(n_steps):
        s_k = V3.from_array(sums[k * n:(k + 1) * n])
        tr_k = med.transmittance_v(st_m, t_k[k * n:(k + 1) * n])
        acc = acc + tr_k * ss_m * s_k * dt
    return acc


def eye_pass(scene: Scene, sampler: mrng.Sampler3, width: int, height: int,
             max_delta_bounces: int):
    """Camera rays to their first smooth vertex through up to
    ``max_delta_bounces`` delta bounces.  Returns ((px, py) film
    positions, the state dict of the vertices (thr, le: the light seen on
    the way, p, frame, uvs, shape, wi_local, sampler), gatherable lanes,
    the primary segment (o, d, t and, with media, the camera's medium))."""
    n = width * height
    dev = scene.device
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    s, blk0 = mrng.next_block4_v(sampler)
    px = (pix % width).to(Float) + blk0[0]
    py = (pix // width).to(Float) + blk0[1]
    o, d, w_sensor = sample_ray_v(scene.sensor, px / width, py / height,
                                  blk0[2], blk0[3])
    emt = scene.emitters
    zeros = v.zeros((n,), dev)
    thr = V3(w_sensor, w_sensor, w_sensor)

    hit = scene.ray_intersect_v(o, d)
    it = scene.interaction_v(o, d, hit)
    t_seg = torch.where(it.valid, hit.t, 2.2 * emt.bsphere_radius)
    prim = dict(o=o, d=d, t=t_seg)
    if scene.media.any:
        mid0 = torch.full((n,), scene.camera_medium, dtype=torch.int32,
                          device=dev)
        _ss, st_m, _pt, _g = med.medium_params_v(scene.media, mid0)
        thr = thr * med.transmittance_v(st_m, t_seg)
        prim["mid"] = mid0
    le = v.where(~it.valid, thr * em.eval_environment_v(emt, d), zeros)
    eid = scene.emitter_at_id(it.shape)
    le = le + v.where(it.valid, thr * em.emitted_radiance_v(
        emt, eid, it.ns, -d), zeros)

    st = dict(thr=thr, active=it.valid, le=le,
              settled=torch.zeros((n,), dtype=torch.bool, device=dev),
              p=it.p, ns=it.ns, ng=it.ng, ss=it.ss, ts=it.ts_,
              uv_u=it.uv_u, uv_v=it.uv_v, shape=it.shape,
              wi_local=it.wi_local, sampler=s)
    for _ in range(max_delta_bounces):
        bparams = scene.bsdf_at_v(_fake_it_v(st))
        settled = st["settled"] | (st["active"] & ~lane_is_delta(bparams))
        walk = st["active"] & ~settled

        s, bsdf_blk = mrng.next_block4_v(st["sampler"])
        bs = bsdf_sample_v(bparams, st["wi_local"], *bsdf_blk)
        wo_world = v.to_world((st["ss"], st["ts"], st["ns"]), bs.wo)
        thr2 = st["thr"] * bs.weight
        hit2 = scene.ray_intersect_v(st["p"], wo_world)
        it2 = scene.interaction_v(st["p"], wo_world, hit2)
        le2 = em.emitted_radiance_v(emt, scene.emitter_at_id(it2.shape),
                                    it2.ns, -wo_world)
        env2 = em.eval_environment_v(emt, wo_world)
        le_new = st["le"] + v.where(
            walk, thr2 * v.where(it2.valid, le2, env2), zeros)
        act2 = walk & it2.valid & (thr2.sum() > 0)

        def pick(new, old):
            if isinstance(new, V3):
                return v.where(walk, new, old)
            return torch.where(walk, new, old)

        st = dict(thr=pick(thr2, st["thr"]),
                  active=torch.where(walk, act2, st["active"]),
                  le=le_new, settled=settled,
                  p=pick(it2.p, st["p"]), ns=pick(it2.ns, st["ns"]),
                  ng=pick(it2.ng, st["ng"]), ss=pick(it2.ss, st["ss"]),
                  ts=pick(it2.ts_, st["ts"]),
                  uv_u=pick(it2.uv_u, st["uv_u"]),
                  uv_v=pick(it2.uv_v, st["uv_v"]),
                  shape=pick(it2.shape, st["shape"]),
                  wi_local=pick(it2.wi_local, st["wi_local"]), sampler=s)
    gatherable = st["settled"] & st["active"]
    return (px, py), st, gatherable, prim


def sppm_pass(scene: Scene, stats: dict, pass_idx: int, seed: int, cell,
              *, width: int, height: int, n_photons: int, max_bounces: int,
              cap: int, alpha: float) -> dict:
    """One iteration: eye pass, photon pass, gather, Hachisuka's update of
    stats = dict(r2 (N,), n (N,), tau V3, ld V3); returns the new stats."""
    dev = scene.device
    n = width * height
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    seed = int(seed) & mrng.MASK32
    _pos, st, gatherable, prim = eye_pass(
        scene, mrng.make_sampler_v(pix, pass_idx, seed), width, height,
        max_delta_bounces=6)

    pid = torch.arange(n_photons, dtype=torch.int64, device=dev)
    p_ph, pw_ph, wi_ph, v_ph, vol = photon_trace(
        scene, mrng.make_sampler_v(pid, pass_idx, seed ^ PHOTON_SEED),
        max_bounces, want_volume=True)
    order, bsorted = build_grid(p_ph, v_ph, cell)
    bparams = scene.bsdf_at_v(_fake_it_v(st))
    flux, m_found = gather(
        p_ph, pw_ph, wi_ph, order, bsorted, st["p"],
        (st["ss"], st["ts"], st["ns"]), st["wi_local"], bparams,
        stats["r2"], cell, cap, active=gatherable)
    zeros = v.zeros((n,), dev)
    flux = v.where(gatherable, flux * st["thr"], zeros)
    m_found = torch.where(gatherable, m_found, 0.0)

    n_old = stats["n"]
    n_new = n_old + alpha * m_found
    ratio = torch.where(m_found > 0, n_new / (n_old + m_found), 1.0)
    ld = stats["ld"] + st["le"]
    if scene.media.any:
        vp, vpow, vwi, vvalid = vol
        order_v, bsorted_v = build_grid(vp, vvalid, cell)
        _s, bblk = mrng.next_block4_v(
            mrng.make_sampler_v(pix, pass_idx, seed ^ BEAM_SEED))
        lb = beam_gather(scene, vp, vpow, vwi, order_v, bsorted_v,
                         prim["o"], prim["d"], prim["t"], prim["mid"], cell,
                         cap, BEAM_STEPS, bblk[0])
        ld = ld + lb / n_photons
    return dict(r2=stats["r2"] * ratio, n=n_new,
                tau=(stats["tau"] + flux / n_photons) * ratio, ld=ld)


def render_sppm(scene: Scene, settings, spp: int | None = None,
                progress_cb=None) -> torch.Tensor:
    """The SPPM image, (H, W, 3) on the scene's device; ``spp`` passes
    (the settings' by default), ``photon_count`` photons a pass (250,000),
    ``max_depth`` bounces (8 when -1), alpha 0.7, ``cell_cap`` 64;
    ``progress_cb(done, passes, stats)`` after each pass."""
    ip = settings.integrator_props
    width, height = settings.width, settings.height
    n_passes = spp if spp is not None else settings.spp
    md = ip.get("max_depth", -1)
    max_bounces = md if md > 0 else 8
    n_photons = int(ip.get("photon_count", 250000))
    alpha = float(ip.get("alpha", 0.7))
    cap = int(ip.get("cell_cap", 64))
    # initial_radius, else lookup_radius_rel of the scene's bounding-sphere
    # radius (globalLookupRadiusRelative)
    r0 = float(ip.get("initial_radius", 0.0))
    if r0 <= 0:
        bsr = float(scene.emitters.bsphere_radius)
        r0 = max(bsr, 1e-3) * float(ip.get("lookup_radius_rel", 0.05))
    # the cells are the largest radius (the radii only shrink)
    cell = cell_tensor(r0, scene.device)

    n = width * height
    dev = scene.device
    zeros = v.zeros((n,), dev)
    stats = dict(r2=torch.full((n,), r0 * r0, dtype=Float, device=dev),
                 n=torch.zeros((n,), dtype=Float, device=dev),
                 tau=zeros, ld=zeros)
    with torch.no_grad():
        for it in range(n_passes):
            stats = sppm_pass(scene, stats, it, settings.seed, cell,
                              width=width, height=height,
                              n_photons=n_photons, max_bounces=max_bounces,
                              cap=cap, alpha=alpha)
            if progress_cb is not None:
                progress_cb(it + 1, n_passes, stats)
    area = (n_passes * math.pi) * torch.clamp_min(stats["r2"], 1e-20)
    img = stats["tau"] / area + stats["ld"] / n_passes
    return torch.stack(list(img), -1).reshape(height, width, 3)
