"""Subsurface scattering (``mitsuba_im_tpu/subsurface/__init__.py``): the
Jensen dipole BSSRDF and the refracted-ray single-scatter estimator.

``dipole``: irradiance is gathered at sample points spread over the
subsurface shapes' triangles by area (:func:`sample_surface_points`, the
reference's numpy draws from ``default_rng(11)`` in the same order, so the
points are its points bit for bit), their direct irradiance is 8 NEE
wavefronts over the points (:func:`compute_irradiance`), and shading adds
Lo = Ft(wo) / pi * sum_p Rd(|x - x_p|) E_p A_p over the points of the
lane's record (:func:`eval_lo`).  Point clouds of at most 1,024 points
take the exact dense sum; larger ones scan the 27 neighbour cells of a
hash grid of cell 4 / min sigma_tr (``integrators/sppm.py::build_grid``),
at most ``grid_cap`` points of a cell, a capped cell's points weighted
full / run.

``singlescatter`` (:func:`eval_lo_single`): the view ray refracts into the
medium, the exit distance comes from a closest-hit cast, a scatter
distance is sampled against the mean extinction on [0, exit], the light is
connected through the boundary (a second closest-hit cast finds the exit
point, an any-hit cast guards the outside segment) with Jensen's corrected
internal length, Fresnel transmittance both ways and Henyey-Greenstein.
The reference's internal-reflection ladder is cut at one segment; that is
its documented deviation, copied.

The reference's dense branch adds (N, 256, 3) chunks over every lane.  The
port evaluates only the lanes whose record is a dipole (the others add
exact zeros there), at most ``SS_PAIRS`` (lane, point) pairs at once, each
point chunk summed over its 256 points and the chunks added in the
reference's order.  The grid branch expands the (lane, cell, slot) pairs
that exist (``sppm.neighbour_runs``/``pair_chunks``), keeps those of the
lane's own record and sums them per lane with ``index_put_(accumulate=True)``
in the reference's loop order (cell, then slot), deterministic on the card,
where the reference runs a ``fori_loop`` of 27 x ``grid_cap`` steps over
every lane.  :data:`SUBSURFACE_STATS` counts the calls, lanes and pairs.

Reference observations (ROADMAP C20, C21): ``bdpt`` (and so pssmlt's
default bidirectional sampler, ``bidir/pathsampler.py``), ``volpath``,
``ptracer`` and ``sppm`` never call :func:`eval_lo`, so a subsurface shape
adds light under ``path`` (and the unidirectional MCMC replays) only; and
:func:`sample_surface_points` samples triangles only, so a ``dipole`` on a
sphere or disk gets no points and adds nothing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.properties import Properties
from ..core.registry import register
from ..core.types import EPSILON, Float, Int, SHADOW_EPSILON
from ..core import v3 as v
from ..core.v3 import V3

# (lane, point) pairs a dense chunk or a grid chunk evaluates at once
SS_PAIRS = 1 << 22
DENSE_MAX = 1024  # point clouds up to this size take the exact dense sum

SUBSURFACE_STATS = dict(calls=0, lanes=0, dense_pairs=0, grid_pairs=0,
                        kept=0)


def reset_subsurface_stats():
    for k in SUBSURFACE_STATS:
        SUBSURFACE_STATS[k] = 0


def _rec(props: Properties, single: bool = False) -> dict:
    sigma_s = np.asarray(props.get_spectrum("sigmaS", [2.6, 3.2, 3.9]))
    sigma_a = np.asarray(props.get_spectrum("sigmaA",
                                            [0.0021, 0.0041, 0.0071]))
    scale = props.get_float("scale", 1.0)
    return dict(
        sigma_s=sigma_s * scale,
        sigma_a=sigma_a * scale,
        g=props.get_float("g", 0.0),
        eta=props.get_float("intIOR", 1.33) / props.get_float("extIOR", 1.0),
        single=single,
    )


@register("subsurface", "dipole")
def _dipole(props: Properties, ctx=None):
    rec = _rec(props)
    if ctx is not None:
        return ctx.add_subsurface(rec)
    return rec


@register("subsurface", "singlescatter")
def _singlescatter(props: Properties, ctx=None):
    rec = _rec(props, single=True)
    if ctx is not None:
        return ctx.add_subsurface(rec)
    return rec


# ---------------------------------------------------------------------------
# The dipole diffusion profile
# ---------------------------------------------------------------------------

def dipole_coeffs(sigma_s, sigma_a, g, eta):
    """The classical dipole's parameters (dipole.cpp configure()), float64:
    per-channel sigma_tr, zr, zv, alpha_p, and fdr, eta."""
    sigma_s = np.asarray(sigma_s, np.float64)
    sigma_a = np.asarray(sigma_a, np.float64)
    sigma_sp = sigma_s * (1.0 - g)          # reduced scattering
    sigma_tp = sigma_sp + sigma_a           # reduced extinction
    alpha_p = sigma_sp / np.maximum(sigma_tp, 1e-12)
    sigma_tr = np.sqrt(3.0 * sigma_a * sigma_tp)
    # internal diffuse reflectance (Groenhuis/Egan approximation)
    fdr = -1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta
    A = (1.0 + fdr) / (1.0 - fdr)
    zr = 1.0 / np.maximum(sigma_tp, 1e-12)
    zv = zr * (1.0 + 4.0 / 3.0 * A)
    return dict(sigma_tr=sigma_tr, zr=zr, zv=zv, alpha_p=alpha_p,
                fdr=fdr, eta=eta)


def rd_profile(r2, sigma_tr, zr, zv, alpha_p):
    """The dipole's diffuse reflectance Rd(r) (Jensen 2001 eq. 4): ``r2``
    (...,) squared radii, the coefficients broadcast per channel against
    (..., 3)."""
    dr = torch.sqrt(r2[..., None] + zr * zr)
    dv = torch.sqrt(r2[..., None] + zv * zv)
    c1 = zr * (sigma_tr * dr + 1.0) * torch.exp(-sigma_tr * dr) / (dr ** 3)
    c2 = zv * (sigma_tr * dv + 1.0) * torch.exp(-sigma_tr * dv) / (dv ** 3)
    return alpha_p / (4.0 * np.pi) * (c1 + c2)


def total_diffuse_reflectance(alpha_p, A):
    """The closed-form integral of Rd over the plane (the dipole's albedo)."""
    alpha_p = np.asarray(alpha_p, np.float64)
    e = np.sqrt(3.0 * (1.0 - alpha_p))
    return alpha_p / 2.0 * (1.0 + np.exp(-4.0 / 3.0 * A * e)) * np.exp(-e)


def _fresnel_t(eta, cos_i):
    """1 - Fr(eta, cos_i), the boundary's transmission."""
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)
    st2 = (1.0 - ci * ci) / (eta * eta)
    tir = st2 >= 1.0
    ct = torch.sqrt(torch.clamp_min(1.0 - st2, 0.0))
    rs = (ci - eta * ct) / torch.clamp_min(ci + eta * ct, 1e-12)
    rp = (eta * ci - ct) / torch.clamp_min(eta * ci + ct, 1e-12)
    fr = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    return 1.0 - fr


# ---------------------------------------------------------------------------
# The device table
# ---------------------------------------------------------------------------

SUBSURFACE_LEAVES = ("sigma_tr", "zr", "zv", "alpha_p", "eta", "sigma_s",
                     "sigma_t", "g", "single", "pts", "irr", "area",
                     "pt_rec", "pt_order", "pt_bucket", "cell")
SUBSURFACE_STATICS = ("n_points", "chunk", "has_single", "grid_cap")
# integer leaves: int32 ids, the grid's int64 order and 32-bit words
_INT_LEAVES = {"single": np.int32, "pt_rec": np.int32,
               "pt_order": np.int64, "pt_bucket": np.int64}


@dataclasses.dataclass(frozen=True)
class SubsurfaceTable:
    """The records' dipole coefficients and the shared point cloud."""

    sigma_tr: torch.Tensor  # (R, 3)
    zr: torch.Tensor
    zv: torch.Tensor
    alpha_p: torch.Tensor
    eta: torch.Tensor  # (R,)
    sigma_s: torch.Tensor  # (R, 3) raw scattering coefficient
    sigma_t: torch.Tensor  # (R, 3) raw extinction
    g: torch.Tensor  # (R,) HG anisotropy
    single: torch.Tensor  # (R,) int32: 1 singlescatter record, 0 dipole
    pts: torch.Tensor  # (P, 3) surface sample points
    irr: torch.Tensor  # (P, 3) irradiance at the points
    area: torch.Tensor  # (P,) area weight of a point
    pt_rec: torch.Tensor  # (P,) int32 record owning the point (-1: pad)
    pt_order: torch.Tensor  # (P,) point ids sorted by hash bucket
    pt_bucket: torch.Tensor  # (P,) the sorted buckets
    cell: torch.Tensor  # () float32 grid cell (4 diffusion lengths)
    n_points: int = 0
    chunk: int = 256
    has_single: bool = False
    grid_cap: int = 64


def table_from_arrays(arrays: dict, statics: dict,
                      device) -> SubsurfaceTable:
    """A table from numpy leaves (``scene/bridge.py``)."""
    return SubsurfaceTable(
        **{k: torch.from_numpy(np.array(
            arrays[k], _INT_LEAVES[k] if k in _INT_LEAVES else np.float32)
           ).to(device) for k in SUBSURFACE_LEAVES},
        **{k: statics[k] for k in SUBSURFACE_STATICS})


def detached(table: SubsurfaceTable) -> SubsurfaceTable:
    """The table with every tensor leaf detached: the constants a gradient
    through the path integrator sees (the reference's table is a constant
    pytree, ``integrators/path.py:128-141``)."""
    return dataclasses.replace(table, **{
        k: getattr(table, k).detach() for k in SUBSURFACE_LEAVES})


def sample_surface_points(builder_tri: dict, shape_ids: list[int],
                          n_points: int, rng: np.random.Generator):
    """Area-weighted triangle sampling over the given shapes (host):
    (points (P, 3), normals (P, 3), total area).  A scene without
    triangles gives no points (the reference raises there, ROADMAP C22)."""
    if not builder_tri["p0"]:
        return np.zeros((0, 3)), np.zeros((0, 3)), 0.0
    tri_shape = np.concatenate([np.asarray(a) for a in builder_tri["shape"]]) \
        if builder_tri["shape"] else np.zeros(0, np.int32)
    mask = np.isin(tri_shape, shape_ids)
    p0 = np.concatenate(builder_tri["p0"])[mask]
    e1 = np.concatenate(builder_tri["e1"])[mask]
    e2 = np.concatenate(builder_tri["e2"])[mask]
    if len(p0) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3)), 0.0
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    total = areas.sum()
    pmf = areas / max(total, 1e-20)
    idx = rng.choice(len(p0), size=n_points, p=pmf)
    u = rng.uniform(size=(n_points, 2))
    su = np.sqrt(u[:, :1])
    b0 = 1.0 - su
    b1 = u[:, 1:] * su
    pts = p0[idx] + e1[idx] * b0 + e2[idx] * b1
    nrm = np.cross(e1[idx], e2[idx])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    return pts, nrm, float(total)


def _v3(a: np.ndarray, device) -> V3:
    t = torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return V3(t[:, 0], t[:, 1], t[:, 2])


def compute_irradiance(scene, pts, nrm, n_samples: int = 8, seed: int = 7):
    """Direct irradiance at the points (P, 3), float32 on the scene's
    device: one NEE wavefront over the points a sample, the shadow test
    through the scene's any-hit kernel (dipole.cpp's irradiance fill)."""
    from ..core import rng as mrng
    from ..emitter import table as em

    dev = scene.device
    p, n = _v3(pts, dev), _v3(nrm, dev)
    P = p.x.shape[0]
    pix = torch.arange(P, dtype=torch.int64, device=dev)
    acc = v.zeros((P,), dev)
    for si in range(n_samples):
        s = mrng.make_sampler_v(pix, si, seed)
        s, blk = mrng.next_block4_v(s)
        ds = em.sample_direct_v(scene.emitters, scene.geom, p, blk[0],
                                blk[1], blk[2])
        cos_i = torch.clamp_min(n.dot(ds.d), 0.0)
        occ = scene.occluded_v(p + n * 1e-4, ds.d, EPSILON,
                               ds.dist * (1.0 - SHADOW_EPSILON))
        ok = (ds.pdf > 0) & ~occ & (cos_i > 0)
        contrib = ds.value * (cos_i / torch.clamp_min(ds.pdf, 1e-20))
        acc = acc + v.where(ok, contrib, v.zeros((P,), dev))
    return torch.stack([c / n_samples for c in acc], dim=1)


def build_subsurface(records: list[dict], builder, scene,
                     points_per_record: int = 512) -> SubsurfaceTable | None:
    """The table of ``records`` once the scene exists (its emitters and
    intersection tables give the points' irradiance), on its device."""
    if not records:
        return None
    from ..integrators.sppm import build_grid, cell_tensor

    dev = scene.device
    rng = np.random.default_rng(11)
    all_pts, all_nrm, all_area, all_rec = [], [], [], []
    for rid, rec in enumerate(records):
        if rec.get("single"):
            continue  # singlescatter records use the refracted-ray estimator
        shape_ids = [sid for sid, ss in enumerate(builder.shape_subsurface)
                     if ss == rid]
        pts, nrm, area = sample_surface_points(
            builder._tri, shape_ids, points_per_record, rng)
        if len(pts) == 0:
            continue
        all_pts.append(pts)
        all_nrm.append(nrm)
        all_area.append(np.full(len(pts), area / len(pts), np.float32))
        all_rec.append(np.full(len(pts), rid, np.int32))
    if all_pts:
        pts = np.concatenate(all_pts)
        nrm = np.concatenate(all_nrm)
        irr = compute_irradiance(scene, pts, nrm)
        area = np.concatenate(all_area)
        recs_arr = np.concatenate(all_rec)
    elif any(r.get("single") for r in records):
        pts = np.zeros((0, 3))
        irr = torch.zeros((0, 3), dtype=Float, device=dev)
        area = np.zeros(0, np.float32)
        recs_arr = np.zeros(0, np.int32)
    else:
        return None
    # pad to a chunk multiple; padded rows carry record -1, which the
    # same-record mask drops
    C = 256
    pad = (-len(pts)) % C
    if pad:
        pts = np.concatenate([pts, np.zeros((pad, 3))])
        irr = torch.cat([irr, torch.zeros((pad, 3), dtype=Float,
                                          device=dev)])
        area = np.concatenate([area, np.zeros(pad, np.float32)])
        recs_arr = np.concatenate([recs_arr, np.full(pad, -1, np.int32)])

    co = [dipole_coeffs(r["sigma_s"], r["sigma_a"], r["g"], r["eta"])
          for r in records]

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    # cell ~ 4 diffusion lengths of the widest profile, so the 27-cell scan
    # covers everything the dipole kernel can still see
    sigma_tr_min = min((float(np.min(c["sigma_tr"])) for c in co),
                       default=1.0)
    cell = cell_tensor(4.0 / max(sigma_tr_min, 1e-3), dev)
    pts_t = f32(pts)
    if len(pts):
        order, bucket = build_grid(
            V3(pts_t[:, 0], pts_t[:, 1], pts_t[:, 2]),
            torch.from_numpy(recs_arr >= 0).to(dev), cell)
    else:
        order = torch.zeros((0,), dtype=torch.int64, device=dev)
        bucket = torch.zeros((0,), dtype=torch.int64, device=dev)
    return SubsurfaceTable(
        **{k: f32(np.stack([c[k] for c in co]))
           for k in ("sigma_tr", "zr", "zv", "alpha_p")},
        eta=f32([c["eta"] for c in co]),
        sigma_s=f32(np.stack([r["sigma_s"] for r in records])),
        sigma_t=f32(np.stack([np.asarray(r["sigma_s"])
                              + np.asarray(r["sigma_a"]) for r in records])),
        g=f32([r["g"] for r in records]),
        single=torch.tensor([1 if r.get("single") else 0 for r in records],
                            dtype=Int, device=dev),
        pts=pts_t, irr=irr, area=f32(area),
        pt_rec=torch.from_numpy(recs_arr.astype(np.int32)).to(dev),
        pt_order=order, pt_bucket=bucket, cell=cell,
        n_points=len(pts), chunk=C,
        has_single=any(bool(r.get("single")) for r in records),
    )


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------

def _dense_sum(table: SubsurfaceTable, x: torch.Tensor, rec: torch.Tensor,
               coef: list) -> torch.Tensor:
    """sum_p Rd E A over every point of the lanes' records, (L, 3): point
    chunks of ``table.chunk`` summed over their points and added in order,
    at most ``SS_PAIRS`` pairs at once."""
    P = table.n_points
    C = min(table.chunk, max(P, 1))
    lanes = max(SS_PAIRS // C, 1)
    out = torch.zeros((x.shape[0], 3), dtype=Float, device=x.device)
    for l0 in range(0, x.shape[0], lanes):
        xl, rl = x[l0:l0 + lanes], rec[l0:l0 + lanes]
        cl = [c[l0:l0 + lanes, None, :] for c in coef]
        mo = torch.zeros((xl.shape[0], 3), dtype=Float, device=x.device)
        for c0 in range(0, P, C):
            pp = table.pts[c0:c0 + C]
            d = xl[:, None, :] - pp[None, :, :]  # (L, C, 3)
            r2 = torch.sum(d * d, dim=-1)
            rd = rd_profile(r2, *cl)  # (L, C, 3)
            rr = table.pt_rec[c0:c0 + C]
            same = (rr[None, :] == rl[:, None]) & (rr[None, :] >= 0)
            w = torch.where(same[..., None],
                            rd * table.area[c0:c0 + C][None, :, None], 0.0)
            mo = mo + torch.sum(w * table.irr[c0:c0 + C][None], dim=1)
            SUBSURFACE_STATS["dense_pairs"] += xl.shape[0] * pp.shape[0]
        out[l0:l0 + lanes] = mo
    return out


def _grid_sum(table: SubsurfaceTable, x: torch.Tensor, rec: torch.Tensor,
              coef: list) -> torch.Tensor:
    """The same sum over the 27 neighbour cells of each lane, at most
    ``grid_cap`` points a cell, a capped cell's points weighted full / run,
    (L, 3)."""
    from ..integrators.sppm import neighbour_runs, pair_chunks

    xv = V3(x[:, 0], x[:, 1], x[:, 2])
    starts, runs, fulls = neighbour_runs(table.pt_bucket, xv, table.cell,
                                         table.grid_cap)
    over = fulls.to(Float) / torch.clamp_min(runs.to(Float), 1.0)
    out = torch.zeros((x.shape[0], 3), dtype=Float, device=x.device)
    counts = dict(chunks=0, pairs=0)
    for q, ci, idx in pair_chunks(starts, runs, SS_PAIRS, counts):
        pid = table.pt_order[idx]
        sel = torch.nonzero(table.pt_rec[pid] == rec[q]).squeeze(1)
        q, ci, pid = q[sel], ci[sel], pid[sel]
        SUBSURFACE_STATS["kept"] += int(sel.numel())
        d = x[q] - table.pts[pid]
        r2 = torch.sum(d * d, dim=-1)
        rd = rd_profile(r2, *(c[q] for c in coef))  # (K, 3)
        w = rd * (table.area[pid] * over[q, ci])[:, None]
        out.index_put_((q,), w * table.irr[pid], accumulate=True)
    SUBSURFACE_STATS["grid_pairs"] += counts["pairs"]
    return out


def eval_lo(table: SubsurfaceTable, x: V3, wo_cos: torch.Tensor,
            rec_id: torch.Tensor) -> V3:
    """The dipole's outgoing radiance at shading points ``x``; ``wo_cos``
    |cos| of the outgoing direction against the shading normal, ``rec_id``
    (N,) the lane's subsurface record (-1: none)."""
    n = rec_id.shape[0]
    R = table.sigma_tr.shape[0]
    active = rec_id >= 0
    rid = torch.clamp(rec_id, 0, R - 1)
    # lanes of a singlescatter record meet no point (their records own
    # none): they add exact zeros in the reference's sum, here nothing
    lanes = torch.nonzero(active & (table.single[rid] == 0)).squeeze(1)
    SUBSURFACE_STATS["calls"] += 1
    SUBSURFACE_STATS["lanes"] += int(lanes.numel())
    mo = torch.zeros((n, 3), dtype=Float, device=rec_id.device)
    if lanes.numel() and table.n_points:
        xs = torch.stack([c[lanes] for c in x], dim=1)
        rl = rid[lanes]
        coef = [getattr(table, k)[rl] for k in ("sigma_tr", "zr", "zv",
                                                "alpha_p")]
        fn = _dense_sum if table.n_points <= DENSE_MAX else _grid_sum
        mo[lanes] = fn(table, xs, rec_id[lanes], coef)
    ft = _fresnel_t(table.eta[rid], wo_cos)
    lo = mo * (ft / np.pi)[:, None]
    lo = torch.where(active[:, None], lo, 0.0)
    return V3(lo[:, 0], lo[:, 1], lo[:, 2])


def eval_lo_single(table: SubsurfaceTable, scene, p: V3, ns: V3,
                   d_world: V3, rec_id: torch.Tensor, blk) -> V3:
    """The refracted-ray single-scatter estimator (singlescatter.cpp
    LoSingle): ``p``, ``ns`` the vertex and its shading normal, ``d_world``
    the incoming ray's direction (into the surface), ``rec_id`` the lane's
    record, ``blk`` four uniforms (the distance, then the light sample).
    One sample per lane: two closest-hit casts and one any-hit cast."""
    from ..emitter import table as em

    N = p.x.shape[0]
    dev = p.x.device
    R = table.sigma_tr.shape[0]
    rid = torch.clamp(rec_id, 0, R - 1)
    is_single = table.single[rid] > 0
    active = (rec_id >= 0) & is_single
    eta = table.eta[rid]
    inv_eta = 1.0 / eta
    sig_s = table.sigma_s[rid]  # (N, 3)
    sig_t = table.sigma_t[rid]
    g = table.g[rid]

    # refract the view ray into the medium across the shading normal
    cos_i = -(d_world.dot(ns))
    active = active & (cos_i > 0)
    sin2t = (1.0 - cos_i * cos_i) * inv_eta * inv_eta
    tir = sin2t >= 1.0
    ct = torch.sqrt(torch.clamp_min(1.0 - sin2t, 0.0))
    wr = (d_world * inv_eta + ns * (cos_i * inv_eta - ct)).normalized()
    ft_in = _fresnel_t(eta, cos_i)
    active = active & ~tir

    # the boundary's exit distance along the refracted ray
    o_in = p - ns * 1e-4
    hx = scene.ray_intersect_v(o_in, wr, active=active)
    t_exit = torch.where(hx.t < 1e30, hx.t, 0.0)
    active = active & (t_exit > 1e-6)

    # the distance sampled against the mean extinction on [0, t_exit]
    sbar = torch.clamp_min((sig_t[:, 0] + sig_t[:, 1] + sig_t[:, 2]) / 3.0,
                           1e-6)
    fmax = 1.0 - torch.exp(-sbar * t_exit)
    u1 = torch.clamp(blk[0], 0.0, 1.0 - 1e-6)
    s_dist = -torch.log(1.0 - u1 * fmax) / sbar
    s_dist = torch.minimum(s_dist, t_exit * (1.0 - 1e-5))
    pdf_s = sbar * torch.exp(-sbar * s_dist) / torch.clamp_min(fmax, 1e-12)
    xs = o_in + wr * s_dist

    # the light connection at the internal point
    ds = em.sample_direct_v(scene.emitters, scene.geom, xs, blk[1], blk[2],
                            blk[3])
    he = scene.ray_intersect_v(xs, ds.d, active=active)
    ie = scene.interaction_v(xs, ds.d, he)
    si = he.t
    exit_ok = ie.valid & (si < ds.dist) & (ds.pdf > 0)
    cos_e = torch.abs(ie.ns.dot(ds.d))

    # Jensen's corrected internal path length (dipole paper eq. 6)
    denom = torch.sqrt(torch.clamp_min(
        1.0 - inv_eta * inv_eta * (1.0 - cos_e * cos_e), 1e-6))
    si_p = si * cos_e / denom
    ft_out = _fresnel_t(inv_eta, cos_e)

    # occlusion of the external segment (exit point -> light)
    x_e = xs + ds.d * si
    occ = scene.occluded_v(x_e + ds.d * 1e-4, ds.d, EPSILON,
                           torch.clamp_min(ds.dist - si, 0.0)
                           * (1.0 - SHADOW_EPSILON),
                           active=active & exit_ok)

    # Henyey-Greenstein between the internal segments
    cos_ph = wr.dot(ds.d)
    ph = (1.0 - g * g) / torch.clamp_min(
        4.0 * np.pi * (1.0 + g * g - 2.0 * g * cos_ph) ** 1.5, 1e-12)

    tr = torch.exp(-(s_dist[:, None] + si_p[:, None]) * sig_t)  # (N, 3)
    scale = ft_in * ft_out * ph / (torch.clamp_min(pdf_s, 1e-20)
                                   * torch.clamp_min(ds.pdf, 1e-20))
    w = V3.from_array(sig_s * tr) * scale
    lo = ds.value * w
    ok = active & exit_ok & ~occ
    return v.where(ok, lo, v.zeros((N,), dev))
