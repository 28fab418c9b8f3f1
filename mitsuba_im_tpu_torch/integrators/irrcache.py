"""Irradiance caching (``mitsuba_im_tpu/integrators/irrcache.py``).

1. Records: the primary hits of the pixels on a grid of stride
   ``resolution`` (the reference's camera-driven placement).
2. Each record's indirect irradiance E from ``irr_samples``
   cosine-distributed hemisphere rays through the nested path tracer with
   ``hide_emitters`` (so direct light, rendered in the final pass, is not
   counted twice), and its validity radius R, the harmonic mean of the
   rays' hit distances clamped to the scene's radius (Ward & Heckbert
   1988) (:func:`estimate_irradiance`).
3. The final pass: emitted light, one next-event sample, and the
   records' irradiance blended with Ward's weights w = 1 / (|p - p_i| /
   R_i + sqrt(1 - n.n_i)), records with w > 1 / quality and n.n_i > 0.1,
   the nearest record where none qualifies, times the BSDF's diffuse
   reflectance / pi (:func:`gather_cache`).

Up to ``DENSE_MAX`` records every pixel meets every record; above it the
``K_DENSE`` records of largest R stay dense and the rest go into the
photon mapper's hash grid (``sppm.py::build_grid``) with cells of quality
x their largest R, each pixel meeting up to ``GRID_CAP`` records of each of
its 27 neighbour cells.

The reference loops over the hemisphere samples and over the grid's 27 x
``GRID_CAP`` slots, a full-width wavefront each.  The port traces
``IRR_LANES`` // records samples in one wavefront and adds them per record
one sample after another, in the reference's order, and expands the grid's
(pixel, cell, slot) pairs in chunks (``sppm.py::pair_chunks``), summing the
weights per pixel with ``index_put_(accumulate=True)`` in the reference's
slot order (deterministic on the card); the nearest record is the first
of least distance in the reference's order (the dense records first).
The dense products run in chunks of ``DENSE_ROWS`` pixels.

A nested ``path`` whose ``max_depth`` is -1 (a scene file's nested
integrator without ``maxDepth``) runs no bounce, as in the reference
(ROADMAP C18): its records then hold no light.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.types import Float, EPSILON, SHADOW_EPSILON
from ..core import v3 as v
from ..core.v3 import V3
from ..core import rng as mrng
from ..bsdf.eval import bsdf_eval_v
from ..emitter import table as em
from ..sampler import KIND_BY_NAME
from ..scene.scene import Scene
from ..sensor.table import sample_ray_v
from .path import PathConfig, path_li_v
from .sppm import (_take, build_grid, cell_tensor, neighbour_runs,
                   pair_chunks)

DENSE_MAX = 1024   # below this record count the exact dense product
K_DENSE = 256      # the largest-R records, always dense
GRID_CAP = 64      # records visited per neighbour cell
IRR_LANES = 1 << 22  # hemisphere rays (records x samples) a wavefront
DENSE_ROWS = 1 << 14  # pixels of one dense-product chunk

GRID_STATS = dict(records=0, dense=0, grid=0, pairs=0)


def estimate_irradiance(scene: Scene, p: V3, ns: V3, ss: V3, ts: V3,
                        valid, seed: int, n_samples: int, max_depth: int):
    """(E V3, R): the records' indirect irradiance (pi times the mean of
    the hemisphere samples' radiance) and their validity radius."""
    m = p.x.shape[0]
    dev = p.x.device
    cfg = PathConfig(max_depth=max_depth, depth_budget=max_depth,
                     hide_emitters=True, coherent=False, remat=False)
    o = p + ns * EPSILON
    e_sum = v.zeros((m,), dev)
    inv_d = torch.zeros((m,), dtype=Float, device=dev)
    rid = torch.arange(m, dtype=torch.int64, device=dev)
    batch = max(1, IRR_LANES // max(m, 1))
    for i0 in range(0, n_samples, batch):
        nb = min(batch, n_samples - i0)
        lane = rid.repeat(nb)
        sidx = torch.arange(i0, i0 + nb, device=dev).repeat_interleave(m)
        sampler, blk = mrng.next_block4_v(
            mrng.make_sampler_v(lane, sidx, seed))
        r = torch.sqrt(blk[0])
        phi = (2.0 * math.pi) * blk[1]
        d_local = V3(r * torch.cos(phi), r * torch.sin(phi),
                     torch.sqrt(torch.clamp_min(1.0 - blk[0], 0.0)))
        d_world = v.to_world((_take(ss, lane), _take(ts, lane),
                              _take(ns, lane)), d_local)
        o_l = _take(o, lane)
        li, _ = path_li_v(scene, sampler, o_l, d_world, cfg)
        hit = scene.ray_intersect_v(o_l, d_world)
        ok = valid[lane]
        li = v.where(ok, li, v.zeros((nb * m,), dev))
        inv = torch.where(ok & hit.valid,
                          1.0 / torch.clamp_min(hit.t, 1e-3), 0.0)
        for b in range(nb):
            sl = slice(b * m, (b + 1) * m)
            e_sum = e_sum + _take(li, sl)
            inv_d = inv_d + inv[sl]
    e_irr = e_sum * (math.pi / n_samples)
    big_r = torch.where(inv_d > 0,
                        n_samples / torch.clamp_min(inv_d, 1e-6), 1e6)
    # bounded by the scene's scale, so that no record sizes the grid's
    # cells beyond it
    r_scene = torch.clamp_min(scene.emitters.bsphere_radius, 1e-3)
    return e_irr, torch.clamp(torch.clamp_min(big_r, 1e-4), max=r_scene)


def _ward(d, ndot, rec_r, valid, inv_q):
    """Ward's weights, zero where a record does not qualify."""
    w = 1.0 / (d / torch.clamp_min(rec_r, 1e-4)
               + torch.sqrt(torch.clamp_min(1.0 - ndot, 0.0)) + 1e-6)
    return torch.where((w > inv_q) & valid & (ndot > 0.1), w, 0.0)


def _dense(p: V3, ns: V3, rec: dict, ids, inv_q):
    """(wsum, sum w E (Q, 3), least distance, E of the first nearest) of
    the records ``ids`` (all where None), pixel chunk by pixel chunk."""
    rp, rn = rec["p"], rec["n"]
    rE, rR, rv = rec["E"], rec["R"], rec["valid"]
    if ids is not None:
        rp, rn, rE, rR, rv = (_take(rp, ids), _take(rn, ids), rE[ids],
                              rR[ids], rv[ids])
    rn_t = torch.stack(list(rn), 0)
    outs = []
    for q0 in range(0, p.x.shape[0], DENSE_ROWS):
        sl = slice(q0, q0 + DENSE_ROWS)
        dx, dy, dz = (p[k][sl, None] - rp[k][None] for k in range(3))
        d = torch.sqrt(dx * dx + dy * dy + dz * dz)
        # a product of the (Q, 3) and (3, M) normals, as the reference's
        # einsum: the same fused multiply-adds, so that a pixel on a
        # record's plane finds sqrt(1 - n.n_i) as the reference does
        ndot = torch.clamp(torch.stack([c[sl] for c in ns], 1) @ rn_t,
                           -1.0, 1.0)
        w = _ward(d, ndot, rR[None], rv[None], inv_q)
        d_n = torch.where(rv[None] & (ndot > 0.0), d, math.inf)
        near = torch.argmin(d_n, 1)
        outs.append((w.sum(1), w @ rE, d_n.gather(1, near[:, None])[:, 0],
                     rE[near]))
    return tuple(torch.cat(c) for c in zip(*outs))


def gather_cache(p: V3, ns: V3, rec: dict, quality: float, grid=None):
    """The records' irradiance at points (p, ns) by Ward's weights, (Q, 3):
    ``rec`` holds p, n (V3), E (M, 3), R, valid; ``grid`` (dense_ids,
    order, bucket_sorted, cell) for the hybrid gather."""
    inv_q = float(np.float32(1.0) / np.float32(quality))
    if grid is None:
        wsum, e_acc, _dmin, e_near = _dense(p, ns, rec, None, inv_q)
        e = e_acc / torch.clamp_min(wsum, 1e-9)[:, None]
        return torch.where((wsum > 0)[:, None], e, e_near)

    dense_ids, order, bucket, cell = grid
    wsum, e_acc, dmin, e_near = _dense(p, ns, rec, dense_ids, inv_q)
    nq = p.x.shape[0]
    dev = p.x.device
    none = torch.iinfo(torch.int64).max
    acc = torch.zeros((nq, 4), dtype=Float, device=dev)
    gmin = torch.full((nq,), math.inf, dtype=Float, device=dev)
    grec = torch.full((nq,), -1, dtype=torch.int64, device=dev)
    starts, runs, _fulls = neighbour_runs(bucket, p, cell, GRID_CAP)
    for q, _ci, idx in pair_chunks(starts, runs):
        ri = order[idx]
        GRID_STATS["pairs"] += int(q.numel())
        dx, dy, dz = (p[k][q] - rec["p"][k][ri] for k in range(3))
        d = torch.sqrt(dx * dx + dy * dy + dz * dz)
        rn = _take(rec["n"], ri)
        ndot = torch.clamp(ns.x[q] * rn.x + ns.y[q] * rn.y + ns.z[q] * rn.z,
                           -1.0, 1.0)
        rv = rec["valid"][ri]
        w = _ward(d, ndot, rec["R"][ri], rv, inv_q)
        sel = torch.nonzero(w > 0).squeeze(1)
        acc.index_put_((q[sel],), torch.cat(
            [w[sel, None], w[sel, None] * rec["E"][ri[sel]]], 1),
            accumulate=True)
        # the grid's nearest record: the least distance, among equals the
        # first pair in the reference's order (a pixel's pairs all lie in
        # one chunk)
        d_n = torch.where(rv & (ndot > 0.0), d, math.inf)
        gmin.scatter_reduce_(0, q, d_n, "amin")
        at_min = torch.nonzero((d_n == gmin[q]) & (d_n < math.inf)
                               ).squeeze(1)
        first = torch.full((nq,), none, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, q[at_min], at_min, "amin")
        grec = torch.where(first < none,
                           ri[torch.clamp_max(first, q.numel() - 1)], grec)
    wsum = wsum + acc[:, 0]
    e_acc = e_acc + acc[:, 1:]
    better = gmin < dmin
    e_near = torch.where(better[:, None],
                         rec["E"][torch.clamp_min(grec, 0)], e_near)
    e = e_acc / torch.clamp_min(wsum, 1e-9)[:, None]
    return torch.where((wsum > 0)[:, None], e, e_near)


def final_pass(scene: Scene, rec: dict, quality: float, sample_idx: int,
               grid, *, width: int, height: int, spp: int, kind: int,
               seed: int):
    """One sample a pixel: emitted light, one next-event sample and the
    cache's indirect light; a V3 of (W * H,) radiances."""
    dev = scene.device
    emt = scene.emitters
    n = width * height
    zeros = v.zeros((n,), dev)
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    s, blk0 = mrng.next_block4_v(mrng.make_sampler_v(
        pix, sample_idx, seed, kind=kind, spp=spp))
    px = (pix % width).to(Float) + blk0[0]
    py = (pix // width).to(Float) + blk0[1]
    o, dr, _w = sample_ray_v(scene.sensor, px / width, py / height,
                             blk0[2], blk0[3])
    hit = scene.ray_intersect_v(o, dr)
    it = scene.interaction_v(o, dr, hit)
    li = v.where(~it.valid, em.eval_environment_v(emt, dr), zeros)
    li = li + v.where(it.valid, em.emitted_radiance_v(
        emt, scene.emitter_at_id(it.shape), it.ns, -dr), zeros)

    bparams = scene.bsdf_at_v(it)
    s, nee = mrng.next_block4_v(s)
    ds = em.sample_direct_v(emt, scene.geom, it.p, nee[0], nee[1], nee[2])
    f = bsdf_eval_v(bparams, it.wi_local,
                    v.to_local((it.ss, it.ts_, it.ns), ds.d))
    occ = scene.occluded_v(it.p, ds.d, EPSILON,
                           ds.dist * (1.0 - SHADOW_EPSILON))
    can = it.valid & (ds.pdf > 0) & ~occ
    li = li + v.where(can, ds.value * f / torch.clamp_min(ds.pdf, 1e-9),
                      zeros)

    e_px = V3.from_array(gather_cache(it.p, it.ns, rec, quality, grid))
    return li + v.where(it.valid, bparams.refl * e_px / math.pi, zeros)


def cache_records(scene: Scene, settings, seed: int):
    """The records of a render: (rec dict, grid or None)."""
    ip = settings.integrator_props
    quality = float(ip.get("quality", 1.0))
    stride = int(ip.get("resolution", 4))
    n_hemi = int(ip.get("irr_samples", 64))
    nested = dict(ip.get("nested", {"name": "path"}))
    max_depth = int(nested.get("max_depth", 3))
    width, height = settings.width, settings.height
    dev = scene.device

    gx = np.arange(stride // 2, width, stride)
    gy = np.arange(stride // 2, height, stride)
    rid = torch.from_numpy((gy[:, None] * width + gx[None, :]).reshape(-1)
                           .astype(np.int64)).to(dev)
    _s, blk = mrng.next_block4_v(mrng.make_sampler_v(rid, 0, seed))
    o, d, _w = sample_ray_v(
        scene.sensor, ((rid % width).to(Float) + 0.5) / width,
        ((rid // width).to(Float) + 0.5) / height, blk[2], blk[3])
    hit = scene.ray_intersect_v(o, d)
    it = scene.interaction_v(o, d, hit)
    e_irr, big_r = estimate_irradiance(
        scene, it.p, it.ns, it.ss, it.ts_, it.valid, (seed + 1) & mrng.MASK32,
        n_hemi, max_depth)
    rec = dict(p=it.p, n=it.ns, E=torch.stack(list(e_irr), 1), R=big_r,
               valid=it.valid)
    m = int(rid.shape[0])
    GRID_STATS.update(records=m, dense=m, grid=0, pairs=0)
    if m <= DENSE_MAX:
        return rec, None
    # the hybrid gather: long-reach records dense, the rest in a hash grid
    # whose cells bound Ward's acceptance radius quality x R
    r_h = big_r.cpu().numpy()
    valid_h = it.valid.cpu().numpy()
    order_r = np.argsort(np.where(valid_h, -r_h, np.inf))
    dense_ids = np.sort(order_r[:K_DENSE]).astype(np.int64)
    in_dense = np.zeros(m, bool)
    in_dense[dense_ids] = True
    grid_mask = valid_h & ~in_dense
    r_grid = r_h[grid_mask]
    r_max = float(r_grid.max()) if r_grid.size else 1.0
    cell = cell_tensor(max(quality * r_max, 1e-4), dev)
    order, bucket = build_grid(it.p, torch.from_numpy(grid_mask).to(dev),
                               cell)
    GRID_STATS.update(dense=int(dense_ids.size), grid=int(grid_mask.sum()))
    return rec, (torch.from_numpy(dense_ids).to(dev), order, bucket, cell)


def render_irrcache(scene: Scene, settings, spp: int | None = None
                    ) -> torch.Tensor:
    """The irradiance-cached image, (H, W, 3) on the scene's device."""
    ip = settings.integrator_props
    quality = float(ip.get("quality", 1.0))
    width, height = settings.width, settings.height
    spp = int(spp if spp is not None else settings.spp)
    kind = KIND_BY_NAME.get(settings.sampler, mrng.INDEPENDENT)
    seed = int(settings.seed) & mrng.MASK32
    with torch.no_grad():
        rec, grid = cache_records(scene, settings, seed)
        acc = None
        for si in range(spp):
            li = final_pass(scene, rec, quality, si, grid, width=width,
                            height=height, spp=spp, kind=kind, seed=seed)
            acc = li if acc is None else acc + li
    img = torch.stack(list(acc / spp), -1).reshape(height, width, 3)
    return torch.nan_to_num(img, nan=0.0, posinf=0.0, neginf=0.0)
