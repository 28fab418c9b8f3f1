"""Fresnel terms (``mitsuba_im_tpu/bsdf/fresnel.py``): the dielectric and
exact conductor terms of the reference's fresnelDielectricExt and
fresnelConductorExact, and the diffuse Fresnel reflectance fit of its
fresnelDiffuseReflectance (``src/libcore/util.cpp``)."""
from __future__ import annotations

import torch

from ..core.v3 import V3, safe_sqrt


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel of a dielectric of relative IOR ``eta`` = int/ext
    (with respect to the normal's side), entering or leaving by the sign of
    cos_theta_i; total internal reflection gives F = 1.  Returns (F,
    cos_theta_t with the sign opposite to cos_theta_i, eta_rel, eta_ti =
    1 / eta_rel)."""
    outside = cos_theta_i >= 0.0
    eta_rel = torch.where(outside, eta, 1.0 / eta)
    eta_ti = 1.0 / eta_rel
    ci = torch.abs(cos_theta_i)
    sin2_t = eta_ti * eta_ti * torch.clamp_min(1.0 - ci * ci, 0.0)
    tir = sin2_t >= 1.0
    ct = safe_sqrt(1.0 - sin2_t)
    rs = (ci - eta_rel * ct) / torch.where(tir, 1.0, ci + eta_rel * ct)
    rp = (eta_rel * ci - ct) / torch.where(tir, 1.0, eta_rel * ci + ct)
    F = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    cos_theta_t = torch.where(outside, -ct, ct)
    return F, cos_theta_t, eta_rel, eta_ti


def fresnel_diffuse_reflectance(eta):
    """Average Fresnel reflectance of diffuse internal scattering (the
    reference's fast d'Eon and Irving fits, eta < 1 and eta >= 1)."""
    inv_eta = 1.0 / eta
    approx_lt1 = (-0.4399 + 0.7099 * inv_eta - 0.3319 * inv_eta ** 2
                  + 0.0636 * inv_eta ** 3)
    inv_eta2 = inv_eta * inv_eta
    inv_eta3 = inv_eta2 * inv_eta
    approx_ge1 = (0.919317 - 3.4793 * inv_eta + 6.75335 * inv_eta2
                  - 7.80989 * inv_eta3 + 4.98554 * inv_eta3 * inv_eta
                  - 1.36881 * inv_eta3 * inv_eta2)
    return torch.where(eta < 1.0, approx_lt1, approx_ge1)


def fresnel_conductor_v(cos_theta_i, eta: V3, k: V3) -> V3:
    """Exact unpolarized conductor Fresnel in component-SoA form; eta, k
    are V3 rgb, cos_theta_i flat (N,).  Returns V3."""
    ci = torch.clamp(torch.abs(cos_theta_i), 0.0, 1.0)
    ci2 = ci * ci
    si2 = 1.0 - ci2
    out = []
    for e, kk in zip(eta, k):
        e2 = e * e
        k2 = kk * kk
        t0 = e2 - k2 - si2
        a2b2 = safe_sqrt(t0 * t0 + e2 * k2 * 4.0)
        t1 = a2b2 + ci2
        a = safe_sqrt((a2b2 + t0) * 0.5)
        t2 = a * (2.0 * ci)
        rs = (t1 - t2) / torch.clamp_min(t1 + t2, 1e-20)
        t3 = a2b2 * ci2 + si2 * si2
        t4 = t2 * si2
        rp = rs * ((t3 - t4) / torch.clamp_min(t3 + t4, 1e-20))
        out.append((rp + rs) * 0.5)
    return V3(*out)
