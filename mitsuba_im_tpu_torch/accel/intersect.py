"""Ray-scene intersection over component-SoA rays
(``mitsuba_im_tpu/accel/intersect.py``).

Triangles of scenes up to ``BRUTE_FORCE_MAX`` go through the brute-force
queries of :mod:`.cuda_intersect`; larger scenes (and instanced tables)
through their two-level hierarchy, :mod:`.cuda_hierarchy`.  Either runs its
CUDA kernel on the card and its plain version on the CPU.  Analytic spheres
and disks are tested in plain torch, one table row at a time at full lane
width, and merged with the triangle hit exactly as the reference does
(``intersect`` :336-374, ``intersect_v`` :462-493, ``occluded`` :525-542).
Where a brute-force scene has no sphere and no disk, the merge reduces to
a record of the triangle hit, which the closest-hit kernel writes itself.

Gradients: triangle ``t`` detached on every path (the reference's
accelerator and hierarchy paths); sphere/disk ``t`` live.  The triangle
queries (the kernels' wrappers) get detached rays and bounds, as the
reference's Pallas and cluster branches (``stop_gradient``, :140, :331,
:457), so no wrapper ever sees a tensor that requires grad; the sphere and
disk tests and the merge run on the live rays, as on every reference
branch (:155-160, :343-345, :462-463).  The reference's CPU brute-force and
BVH branches leave the triangle ``t`` live too (:147-152, :335-336); the
port follows its accelerated paths.  Visibility (``occluded_v``) is a
boolean and carries no gradient.

``active`` masks lanes off on the hierarchy path (they report no triangle
hit), as in the reference; brute force tests every lane.  Unlike the
reference, an inactive lane also tests no sphere and no disk: its ray
(after a miss, the origin o + d 3e37) makes the quadric's inf - inf, which
a masked forward hides but a backward turns into NaN for every gradient
through a ray direction.  Active lanes' records are the reference's.
``coherent`` only chose the reference's full-width prologue for camera
rays, a TPU scheduling choice that does not change results, so it has no
effect here.
"""
from __future__ import annotations

import torch

from ..core.types import Float, Int, INVALID
from ..core.v3 import V3, safe_sqrt
from ..scene.geometry import (Geometry, Hit, KIND_NONE, KIND_TRI,
                              KIND_SPHERE, KIND_DISK)
from . import cuda_hierarchy as ch
from . import cuda_intersect as ci
from .hierarchy import Hierarchy

BRUTE_FORCE_MAX = 512  # tris; above this the reference uses its hierarchy
BIG = 3.0e37


def _use_hierarchy(geom: Geometry, clusters: Hierarchy | None) -> bool:
    if clusters is not None and (geom.n_tris > BRUTE_FORCE_MAX
                                 or clusters.indirect):
        return True
    if geom.n_tris > BRUTE_FORCE_MAX:
        raise ValueError(
            f"{geom.n_tris} triangles: scenes above {BRUTE_FORCE_MAX} are "
            "traversed through their two-level hierarchy, and none was given")
    return False


def _sg(x):
    """``x`` without grad (a tensor's detached alias, a number as it is)."""
    if isinstance(x, torch.Tensor) and x.requires_grad:
        return x.detach()
    return x


def _sg_v(w: V3) -> V3:
    return V3(_sg(w.x), _sg(w.y), _sg(w.z))


def _sphere_best_v(geom: Geometry, o: V3, d: V3, tmin, tmax):
    """Loop over the (tiny) sphere table at full lane width."""
    R = o.x.shape[0]
    best_t = torch.full((R,), BIG, dtype=Float, device=o.x.device)
    best_i = torch.zeros((R,), dtype=Int, device=o.x.device)
    a = d.dot(d)
    for k in range(geom.n_spheres):
        c = V3(geom.sph_center[k, 0], geom.sph_center[k, 1],
               geom.sph_center[k, 2])
        radius = geom.sph_radius[k]
        L = o - c
        b = 2.0 * d.dot(L)
        cc = L.dot(L) - radius * radius
        disc = b * b - 4 * a * cc
        ok = disc >= 0.0
        sq = safe_sqrt(disc)
        sb = torch.where(b >= 0.0, 1.0, -1.0)
        q = -0.5 * (b + sb * sq)
        t0 = q / torch.where(a == 0, 1.0, a)
        t1 = cc / torch.where(q == 0, 1.0, q)
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        t = torch.where((lo > tmin) & (lo < tmax), lo, hi)
        hit = ok & (t > tmin) & (t < tmax) & (radius > 0) & (t < best_t)
        best_t = torch.where(hit, t, best_t)
        best_i = torch.where(hit, k, best_i)
    return best_i, best_t, best_t < BIG


def _disk_best_v(geom: Geometry, o: V3, d: V3, tmin, tmax):
    R = o.x.shape[0]
    best_t = torch.full((R,), BIG, dtype=Float, device=o.x.device)
    best_i = torch.zeros((R,), dtype=Int, device=o.x.device)
    for k in range(geom.n_disks):
        c = V3(geom.disk_center[k, 0], geom.disk_center[k, 1],
               geom.disk_center[k, 2])
        n = V3(geom.disk_n[k, 0], geom.disk_n[k, 1], geom.disk_n[k, 2])
        radius = geom.disk_radius[k]
        denom = d.dot(n)
        tt = (c - o).dot(n) / torch.where(denom == 0, 1.0, denom)
        local = o + d * tt - c
        r2 = local.dot(local) - local.dot(n) ** 2
        hit = ((torch.abs(denom) > 1e-12) & (tt > tmin) & (tt < tmax)
               & (r2 <= radius * radius) & (radius > 0) & (tt < best_t))
        best_t = torch.where(hit, tt, best_t)
        best_i = torch.where(hit, k, best_i)
    return best_i, best_t, best_t < BIG


def intersect_v(geom: Geometry, o: V3, d: V3, tmin, tmax,
                clusters: Hierarchy | None = None, active=None,
                coherent=False) -> Hit:
    """Closest hit over SoA rays (``coherent``: see the module note).

    A brute-force scene of triangles only takes its hit record from the
    closest-hit query itself (``cuda_intersect.closest_hit_v``, equal to
    :func:`merge_hits` there); every other scene merges."""
    rays = (_sg_v(o), _sg_v(d), _sg(tmin), _sg(tmax))
    if _use_hierarchy(geom, clusters):
        t, u, v, prim, _, found = ch.hier_closest(clusters, *rays,
                                                  active=active)
        return merge_hits(geom, o, d, tmin, tmax, (t, u, v, prim, found),
                          active)
    tris = (geom.tri_p0, geom.tri_e1, geom.tri_e2)
    if not (geom.n_spheres or geom.n_disks):
        return Hit(*ci.closest_hit_v(*tris, geom.tri_shape, *rays))
    return merge_hits(geom, o, d, tmin, tmax,
                      ci.closest_tris_v(*tris, *rays), active)


def merge_hits(geom: Geometry, o: V3, d: V3, tmin, tmax, tri,
               active=None) -> Hit:
    """The closest of the triangle hit ``tri`` = (t, u, v, prim, found) and
    the scene's spheres and disks, as the reference merges them; lanes off
    in ``active`` test no sphere or disk (see the module note)."""
    tbest, tu, tv, ti, tvalid = tri
    lanes_off = active is not None and (geom.n_spheres or geom.n_disks)
    if lanes_off:
        o = V3(*(torch.where(active, c, 0.0) for c in o))
    si, sbest, _ = _sphere_best_v(geom, o, d, tmin, tmax)
    di, dbest, _ = _disk_best_v(geom, o, d, tmin, tmax)
    if lanes_off:
        sbest = torch.where(active, sbest, BIG)
        dbest = torch.where(active, dbest, BIG)

    tbest = torch.where(tvalid, tbest, BIG)
    best = torch.minimum(torch.minimum(tbest, sbest), dbest)
    kind = torch.where(
        best >= BIG, KIND_NONE,
        torch.where(tbest == best, KIND_TRI,
                    torch.where(sbest == best, KIND_SPHERE, KIND_DISK)),
    ).to(Int)
    is_tri = kind == KIND_TRI
    is_sph = kind == KIND_SPHERE
    prim = torch.where(is_tri, ti, torch.where(is_sph, si, di))
    shape = torch.where(
        is_tri, geom.tri_shape[prim.clamp(0, geom.tri_shape.shape[0] - 1)],
        torch.where(
            is_sph, geom.sph_shape[prim.clamp(0, geom.sph_shape.shape[0] - 1)],
            geom.disk_shape[prim.clamp(0, geom.disk_shape.shape[0] - 1)]),
    )
    miss = kind == KIND_NONE
    return Hit(
        t=torch.where(miss, BIG, best),
        kind=kind,
        prim=torch.where(miss, 0, prim).to(Int),
        shape=torch.where(miss, INVALID, shape).to(Int),
        u=torch.where(is_tri, tu, 0.0),
        v=torch.where(is_tri, tv, 0.0),
    )


def occluded_v(geom: Geometry, o: V3, d: V3, tmin, tmax,
               clusters: Hierarchy | None = None,
               active=None) -> torch.Tensor:
    """Any-hit (shadow ray) query over SoA rays -> (N,) bool."""
    o, d, tmin, tmax = _sg_v(o), _sg_v(d), _sg(tmin), _sg(tmax)
    if _use_hierarchy(geom, clusters):
        blocked = ch.hier_anyhit(clusters, o, d, tmin, tmax, active=active)
    else:
        blocked = ci.anyhit_tris_v(geom.tri_p0, geom.tri_e1, geom.tri_e2,
                                   o, d, tmin, tmax)
    if geom.n_spheres:
        blocked = blocked | _sphere_best_v(geom, o, d, tmin, tmax)[2]
    if geom.n_disks:
        blocked = blocked | _disk_best_v(geom, o, d, tmin, tmax)[2]
    return blocked
