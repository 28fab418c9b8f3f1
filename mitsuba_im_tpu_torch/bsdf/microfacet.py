"""Microfacet distributions (``mitsuba_im_tpu/bsdf/microfacet.py``): GGX,
Beckmann and Phong normal densities, Smith shadowing, and visible-normal
sampling (Heitz's VNDF for GGX; Beckmann and Phong sample the full NDF).

Every function evaluates all three distributions and selects per lane by
``dist``, as the reference does, so both agree lane for lane.
"""
from __future__ import annotations

import torch

from ..core import v3 as v
from ..core.v3 import V3, INV_PI, PI, safe_div

DIST_BECKMANN = 0
DIST_GGX = 1
DIST_PHONG = 2


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp_min(x, 0.0))


def ndf_v(dist, m_vec: V3, au, av):
    """D(m): density of microfacet normals (projected-area normalized)."""
    ct = m_vec.z
    ct2 = ct * ct
    valid = ct > 0
    x2 = m_vec.x * m_vec.x
    y2 = m_vec.y * m_vec.y

    # Beckmann
    exponent_b = -(x2 / (au * au) + y2 / (av * av)) / torch.clamp_min(ct2,
                                                                       1e-12)
    d_beck = torch.exp(exponent_b) / torch.clamp_min(
        PI * au * av * ct2 * ct2, 1e-20)

    # GGX
    denom = x2 / (au * au) + y2 / (av * av) + ct2
    d_ggx = 1.0 / torch.clamp_min(PI * au * av * denom * denom, 1e-20)

    # Phong (isotropic, exponent derived from alpha_u)
    exp_p = 2.0 / torch.clamp_min(au * au, 1e-12) - 2.0
    d_phong = (exp_p + 2.0) * (0.5 * INV_PI) * torch.pow(
        torch.clamp_min(ct, 1e-12), exp_p)

    d = torch.where(dist == DIST_GGX, d_ggx,
                    torch.where(dist == DIST_PHONG, d_phong, d_beck))
    return torch.where(valid, d, 0.0)


def _project_roughness2_v(w: V3, au, av):
    """Squared roughness along w's azimuth (for anisotropic Smith)."""
    st2 = v.sin_theta2(w)
    inv_st2 = safe_div(1.0, st2, fallback=1.0)
    cos_phi2 = w.x * w.x * inv_st2
    sin_phi2 = w.y * w.y * inv_st2
    iso = st2 <= 1e-12
    return torch.where(iso, au * au, cos_phi2 * au * au + sin_phi2 * av * av)


def smith_g1_v(dist, w: V3, m_vec: V3, au, av):
    """Smith masking for direction w given microfacet normal m."""
    ct = w.z
    chi = (w.dot(m_vec) * ct) > 0
    tan2 = v.tan_theta2(w)
    a2 = _project_roughness2_v(w, au, av)

    # GGX closed form
    g_ggx = 2.0 / (1.0 + torch.sqrt(1.0 + a2 * tan2))

    # Beckmann rational fit, also used for Phong via an equivalent exponent
    sq_tan = torch.sqrt(torch.clamp_min(tan2, 0.0))
    a = 1.0 / torch.clamp_min(torch.sqrt(a2) * sq_tan, 1e-12)
    ab = torch.where(
        dist == DIST_PHONG,
        torch.sqrt((2.0 / torch.clamp_min(au * au, 1e-12)) * 0.5)
        / torch.clamp_min(sq_tan, 1e-12),
        a)
    g_rat = torch.where(
        ab >= 1.6,
        1.0,
        (3.535 * ab + 2.181 * ab * ab) / (1.0 + 2.276 * ab + 2.577 * ab * ab),
    )

    g = torch.where(dist == DIST_GGX, g_ggx, g_rat)
    g = torch.where(tan2 <= 1e-16, 1.0, g)
    return torch.where(chi, g, 0.0)


def smith_g2_v(dist, wi: V3, wo: V3, m_vec: V3, au, av):
    return smith_g1_v(dist, wi, m_vec, au, av) * smith_g1_v(
        dist, wo, m_vec, au, av)


def sample_ggx_vndf_v(wi: V3, au, av, u1, u2):
    """Heitz 2018 VNDF sampling for GGX (handles wi from either side)."""
    flip = wi.z < 0
    wi_f = v.where(flip, -wi, wi)
    vh = V3(au * wi_f.x, av * wi_f.y, wi_f.z).normalized()
    lensq = vh.x * vh.x + vh.y * vh.y
    inv_len = torch.rsqrt(torch.clamp_min(lensq, 1e-14))
    good = lensq > 1e-14
    t1 = V3(torch.where(good, -vh.y * inv_len, 1.0),
            torch.where(good, vh.x * inv_len, 0.0),
            torch.zeros_like(lensq))
    t2 = vh.cross(t1)
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh.z)
    p2 = (1.0 - s) * _safe_sqrt(1.0 - p1 * p1) + s * p2
    nh = t1 * p1 + t2 * p2 + vh * _safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    return V3(au * nh.x, av * nh.y, torch.clamp_min(nh.z, 1e-6)).normalized()


def sample_visible_v(dist, wi: V3, au, av, u1, u2):
    """Sample a microfacet normal; returns (m, pdf(m))."""
    m_ggx = sample_ggx_vndf_v(wi, au, av, u1, u2)

    # Beckmann: full NDF sampling (isotropic and anisotropic)
    phi_b = 2.0 * PI * u2
    phi_b_aniso = torch.atan2(av * torch.sin(phi_b), au * torch.cos(phi_b))
    cp, sp = torch.cos(phi_b_aniso), torch.sin(phi_b_aniso)
    a2inv = (cp * cp / torch.clamp_min(au * au, 1e-12)
             + sp * sp / torch.clamp_min(av * av, 1e-12))
    log_u = torch.log(torch.clamp_min(1.0 - u1, 1e-20))
    tan2_b = -log_u / torch.clamp_min(a2inv, 1e-12)
    ct_b = torch.rsqrt(1.0 + tan2_b)
    st_b = _safe_sqrt(1.0 - ct_b * ct_b)
    m_beck = V3(st_b * cp, st_b * sp, ct_b)

    # Phong: cos^n sampling
    exp_p = 2.0 / torch.clamp_min(au * au, 1e-12) - 2.0
    ct_p = torch.pow(torch.clamp_min(u1, 1e-20), 1.0 / (exp_p + 2.0))
    st_p = _safe_sqrt(1.0 - ct_p * ct_p)
    phi_p = 2.0 * PI * u2
    m_ph = V3(st_p * torch.cos(phi_p), st_p * torch.sin(phi_p), ct_p)

    mvec = v.where(dist == DIST_GGX, m_ggx,
                   v.where(dist == DIST_PHONG, m_ph, m_beck))
    return mvec, pdf_visible_v(dist, wi, mvec, au, av)


def pdf_visible_v(dist, wi: V3, m_vec: V3, au, av):
    """pdf of sample_visible in the half-vector measure."""
    d = ndf_v(dist, m_vec, au, av)
    ggx_code = torch.full(m_vec.x.shape, DIST_GGX, dtype=torch.int32,
                          device=m_vec.x.device)
    pdf_ggx = (smith_g1_v(ggx_code, wi, m_vec, au, av)
               * torch.abs(wi.dot(m_vec)) * d
               / torch.clamp_min(torch.abs(wi.z), 1e-8))
    pdf_ndf = d * torch.clamp_min(m_vec.z, 0.0)
    return torch.where(dist == DIST_GGX, pdf_ggx, pdf_ndf)
