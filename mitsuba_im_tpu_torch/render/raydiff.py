"""Ray differentials: pixel footprints for MIP/anisotropic texture filtering
(``mitsuba_im_tpu/render/raydiff.py``).

The footprint is computed in closed form on the wavefront, with no per-ray
state carried through bounces: :func:`camera_ray_differentials` evaluates
the sensor at +1-pixel film offsets, and :func:`uv_differentials`
transfers the offset rays to the primary hit's triangle plane and solves
its 2x2 barycentric system (exact for triangles).  Secondary bounces look
textures up unfiltered, as in the reference.

The reference reads the triangle's edges and uvs per leaf for meshes of at
most 64 triangles and from the packed shading row above that; both hold
the same float32 values, and the port's ``Geometry`` always has the
packed row, so it reads that.
"""
from __future__ import annotations

import torch

from ..core import v3 as v
from ..core.v3 import V3
from ..scene.geometry import KIND_TRI


def camera_ray_differentials(sensor, uv_u, uv_v, u_lens_a, u_lens_b,
                             inv_w: float, inv_h: float):
    """Direction differences (dddx, dddy) of the primary ray for +1-pixel
    film offsets (origin shifts of non-pinhole sensors are left out, as in
    the reference)."""
    from ..sensor.table import sample_ray_v

    _, d0, _ = sample_ray_v(sensor, uv_u, uv_v, u_lens_a, u_lens_b)
    _, dx, _ = sample_ray_v(sensor, uv_u + inv_w, uv_v, u_lens_a, u_lens_b)
    _, dy, _ = sample_ray_v(sensor, uv_u, uv_v + inv_h, u_lens_a, u_lens_b)
    return dx - d0, dy - d0


def uv_differentials(geom, hit, o: V3, d: V3, dddx: V3, dddy: V3):
    """Screen-space uv derivatives (du/dx, dv/dx, du/dy, dv/dy) at the
    primary hit, flat (N,) tensors, zero on misses and non-triangle
    lanes."""
    is_tri = hit.kind == KIND_TRI
    tp = torch.where(is_tri, hit.prim, 0)
    p0 = v.gather_v3(geom.tri_p0, tp)
    row = geom.tri_shad[tp]
    e1 = V3(row[:, 0], row[:, 1], row[:, 2])
    e2 = V3(row[:, 3], row[:, 4], row[:, 5])
    uv0u, uv0v = row[:, 15], row[:, 16]
    uv1u, uv1v = row[:, 17], row[:, 18]
    uv2u, uv2v = row[:, 19], row[:, 20]
    n = e1.cross(e2)

    # 2x2 Gram system for the barycentrics of a point on the plane
    g11 = e1.dot(e1)
    g12 = e1.dot(e2)
    g22 = e2.dot(e2)
    det = g11 * g22 - g12 * g12
    big = torch.abs(det) > 1e-20
    inv_det = torch.where(big, 1.0 / torch.where(big, det, 1.0), 0.0)
    num = (p0 - o).dot(n)

    def transfer(doff: V3):
        dk = d + doff
        denom = dk.dot(n)
        tk = num / torch.where(torch.abs(denom) > 1e-20, denom, 1.0)
        r = o + dk * tk - p0
        r1 = r.dot(e1)
        r2 = r.dot(e2)
        b1 = (g22 * r1 - g12 * r2) * inv_det
        b2 = (g11 * r2 - g12 * r1) * inv_det
        w = 1.0 - b1 - b2
        return (uv0u * w + uv1u * b1 + uv2u * b2,
                uv0v * w + uv1v * b1 + uv2v * b2)

    # the uv at the hit itself, from its barycentrics
    w0 = 1.0 - hit.u - hit.v
    u_hit = uv0u * w0 + uv1u * hit.u + uv2u * hit.v
    v_hit = uv0v * w0 + uv1v * hit.u + uv2v * hit.v

    ux, vx = transfer(dddx)
    uy, vy = transfer(dddy)
    ok = is_tri & hit.valid
    return tuple(torch.where(ok, a, 0.0) for a in
                 (ux - u_hit, vx - v_hit, uy - u_hit, vy - v_hit))
