"""BSDF evaluate / pdf / sample with static type dispatch
(``mitsuba_im_tpu/bsdf/eval.py``): DIFFUSE and ROUGHCONDUCTOR.

Conventions as in the reference: directions live in the local shading frame
(+z = shading normal), ``wi`` points toward the previous vertex, ``eval``
returns f * |cos_theta_o| and ``sample`` the weight f*cos/pdf.  Every other
type in ``used_types`` raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.types import Float
from ..core import v3 as v
from ..core.v3 import V3, INV_PI, safe_div
from . import microfacet as mf
from .common import LaneParams3, DIFFUSE, ROUGHCONDUCTOR, FLAG_TWOSIDED
from .fresnel import fresnel_conductor_v

PORTED = (DIFFUSE, ROUGHCONDUCTOR)


class BSDFSample3(NamedTuple):
    wo: V3
    weight: V3  # f*cos/pdf
    pdf: torch.Tensor  # solid-angle pdf of smooth lobes (delta: 1.0)
    delta: torch.Tensor  # bool — sampled a delta component
    eta: torch.Tensor  # relative-IOR change along the sampled lobe
    null_passthrough: torch.Tensor  # bool — mask/null straight-through


def _check_types(p: LaneParams3):
    for t in p.used_types:
        if t not in PORTED:
            raise NotImplementedError(
                f"BSDF type {t}: only DIFFUSE and ROUGHCONDUCTOR are ported")


def _m3(ok, val: V3) -> V3:
    """val where ok else 0 (per component)."""
    return V3(torch.where(ok, val.x, 0.0), torch.where(ok, val.y, 0.0),
              torch.where(ok, val.z, 0.0))


def _maybe_flip(p, wi: V3, wo: V3 | None = None):
    """Twosided wrapper: mirror the frame for back-facing lanes."""
    flip = ((p.flags & FLAG_TWOSIDED) != 0) & (wi.z < 0)
    fz = torch.where(flip, -1.0, 1.0)
    wi2 = V3(wi.x, wi.y, wi.z * fz)
    if wo is None:
        return wi2, flip
    return wi2, V3(wo.x, wo.y, wo.z * fz), flip


def _eval_diffuse(p, wi, wo):
    """src/bsdfs/diffuse.cpp"""
    ok = (wi.z > 0) & (wo.z > 0)
    val = p.refl * (INV_PI * torch.clamp_min(wo.z, 0.0))
    return _m3(ok, val)


def _pdf_diffuse(p, wi, wo):
    ok = (wi.z > 0) & (wo.z > 0)
    return torch.where(ok, v.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _eval_roughconductor(p, wi, wo):
    """src/bsdfs/roughconductor.cpp: D*G*F/(4 cos_i) (already x cos_o)."""
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    h = (wi + wo).normalized()
    D = mf.ndf_v(p.dist, h, p.alpha_u, p.alpha_v)
    G = mf.smith_g2_v(p.dist, wi, wo, h, p.alpha_u, p.alpha_v)
    F = fresnel_conductor_v(wi.dot(h), p.eta, p.k)
    val = p.spec * F * (D * G / torch.clamp_min(4.0 * ci, 1e-8))
    return _m3(ok & (D > 0), val)


def _pdf_roughconductor(p, wi, wo):
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    h = (wi + wo).normalized()
    pm = mf.pdf_visible_v(p.dist, wi, h, p.alpha_u, p.alpha_v)
    return torch.where(
        ok, pm / torch.clamp_min(4.0 * torch.abs(wo.dot(h)), 1e-8), 0.0)


_EVAL = {
    DIFFUSE: (_eval_diffuse, _pdf_diffuse),
    ROUGHCONDUCTOR: (_eval_roughconductor, _pdf_roughconductor),
}


def bsdf_eval_v(p: LaneParams3, wi: V3, wo: V3) -> V3:
    """f(wi, wo) * |cos_theta_o| over smooth components."""
    _check_types(p)
    wi, wo, _ = _maybe_flip(p, wi, wo)
    out = v.zeros(p.type.shape, p.type.device)
    for t in p.used_types:
        out = v.where(p.type == t, _EVAL[t][0](p, wi, wo), out)
    return out


def bsdf_pdf_v(p: LaneParams3, wi: V3, wo: V3) -> torch.Tensor:
    """Solid-angle pdf of bsdf_sample landing at wo."""
    _check_types(p)
    wi, wo, _ = _maybe_flip(p, wi, wo)
    out = torch.zeros(p.type.shape, dtype=Float, device=p.type.device)
    for t in p.used_types:
        out = torch.where(p.type == t, _EVAL[t][1](p, wi, wo), out)
    return out


def _sample_roughconductor(p, wi, u2a, u2b):
    """Visible-normal sample, weight = eval/pdf (the reference's
    ``_sample_smooth_family`` branch of this type)."""
    h, _ = mf.sample_visible_v(p.dist, wi, p.alpha_u, p.alpha_v, u2a, u2b)
    wo = v.reflect_n(wi, h).normalized()
    ev = _eval_roughconductor(p, wi, wo)
    pdf = _pdf_roughconductor(p, wi, wo)
    w = ev * safe_div(1.0, pdf)
    return wo, _m3(pdf > 1e-12, w), torch.clamp_min(pdf, 1e-20)


def bsdf_sample_v(p: LaneParams3, wi: V3, u_lobe, u2a, u2b) -> BSDFSample3:
    """Importance-sample the BSDF: (u2a, u2b) drive the directional warp
    (``u_lobe`` picks lobes in the reference; the ported types have one)."""
    _check_types(p)
    wi_f, flip = _maybe_flip(p, wi)
    shape, dev = p.type.shape, p.type.device
    zero = torch.zeros(shape, dtype=Float, device=dev)
    one = torch.ones(shape, dtype=Float, device=dev)
    wo = V3(zero, zero, one)
    weight = v.zeros(shape, dev)
    pdf = zero
    delta = torch.zeros(shape, dtype=torch.bool, device=dev)
    eta = one

    for t in p.used_types:
        sel = p.type == t
        if t == DIFFUSE:
            wo_t = v.square_to_cosine_hemisphere(u2a, u2b)
            pdf_t = v.square_to_cosine_hemisphere_pdf(wo_t)
            w_t = _m3(wi_f.z > 0, p.refl)
        else:
            wo_t, w_t, pdf_t = _sample_roughconductor(p, wi_f, u2a, u2b)
        wo = v.where(sel, wo_t, wo)
        weight = v.where(sel, w_t, weight)
        pdf = torch.where(sel, pdf_t, pdf)
        delta = torch.where(sel, False, delta)
        eta = torch.where(sel, 1.0, eta)

    # un-flip for twosided lanes
    fz = torch.where(flip, -1.0, 1.0)
    wo = V3(wo.x, wo.y, wo.z * fz)
    return BSDFSample3(wo=wo, weight=weight, pdf=pdf, delta=delta, eta=eta,
                       null_passthrough=torch.zeros_like(delta))
