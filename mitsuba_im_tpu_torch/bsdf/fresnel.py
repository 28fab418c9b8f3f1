"""Fresnel terms (``mitsuba_im_tpu/bsdf/fresnel.py``): the exact
conductor term of the reference's fresnelConductorExact
(``src/libcore/util.cpp``)."""
from __future__ import annotations

import torch

from ..core.v3 import V3, safe_sqrt


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
