"""BSDF evaluate / pdf / sample with static type dispatch
(``mitsuba_im_tpu/bsdf/eval.py``): every untextured family of the
reference but IRAWAN.

Conventions as in the reference: directions live in the local shading frame
(+z = shading normal), ``wi`` points toward the previous vertex, ``eval``
returns f * |cos_theta_o| of the smooth components only and ``sample`` the
weight f*cos/pdf.  Delta components (CONDUCTOR, DIELECTRIC, THINDIELECTRIC,
NULL, and the delta lobes of PLASTIC, COATING and HK) have eval = pdf = 0,
so next-event estimation gives them nothing and ``bsdf_sample_v`` alone
reaches them, with ``delta`` set, the lobe's relative ``eta`` (refraction)
and ``null_passthrough`` (NULL) as the reference gives them.  IRAWAN and
the MASK/BLEND/bump wrappers in ``used_types`` raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.types import Float
from ..core import v3 as v
from ..core.v3 import V3, INV_PI, PI, safe_div, safe_sqrt
from . import microfacet as mf
from .common import (
    LaneParams3, DIFFUSE, ROUGHDIFFUSE, CONDUCTOR, ROUGHCONDUCTOR,
    DIELECTRIC, THINDIELECTRIC, ROUGHDIELECTRIC, PLASTIC, ROUGHPLASTIC,
    PHONG, WARD, NULL_BSDF, DIFFTRANS, COATING, HK, FLAG_TWOSIDED,
)
from .fresnel import (fresnel_conductor_v, fresnel_dielectric,
                      fresnel_diffuse_reflectance)
from .rtrans import rtrans_diffuse_v, rtrans_eval_v

PORTED = (DIFFUSE, ROUGHDIFFUSE, CONDUCTOR, ROUGHCONDUCTOR, DIELECTRIC,
          THINDIELECTRIC, ROUGHDIELECTRIC, PLASTIC, ROUGHPLASTIC, PHONG,
          WARD, NULL_BSDF, DIFFTRANS, COATING, HK)


class BSDFSample3(NamedTuple):
    wo: V3
    weight: V3  # f*cos/pdf (discrete lobe probabilities included)
    pdf: torch.Tensor  # solid-angle pdf of smooth lobes (delta: 1.0)
    delta: torch.Tensor  # bool — sampled a delta component
    eta: torch.Tensor  # relative-IOR change along the sampled lobe
    null_passthrough: torch.Tensor  # bool — mask/null straight-through


def _check_types(p: LaneParams3):
    for t in p.used_types:
        if t not in PORTED:
            raise NotImplementedError(
                f"BSDF type {t}: IRAWAN and the MASK/BLEND/bump wrappers "
                "are not ported yet")


def _m3(ok, val: V3) -> V3:
    """val where ok else 0 (per component)."""
    return V3(torch.where(ok, val.x, 0.0), torch.where(ok, val.y, 0.0),
              torch.where(ok, val.z, 0.0))


def _over_pdf(ok, ev: V3, pdf) -> V3:
    """ev / pdf where ok, else 0.  Lanes that are not ok divide by nothing,
    so the huge reciprocal of a tiny pdf never meets their zero cotangent
    (the reference divides them and masks the result, whose reverse-mode
    derivative is then NaN)."""
    return _m3(ok, ev * safe_div(1.0, torch.where(ok, pdf, 0.0)))


def _maybe_flip(p, wi: V3, wo: V3 | None = None):
    """Twosided wrapper: mirror the frame for back-facing lanes."""
    flip = ((p.flags & FLAG_TWOSIDED) != 0) & (wi.z < 0)
    fz = torch.where(flip, -1.0, 1.0)
    wi2 = V3(wi.x, wi.y, wi.z * fz)
    if wo is None:
        return wi2, flip
    return wi2, V3(wo.x, wo.y, wo.z * fz), flip


# ---------------------------------------------------------------------------
# smooth-component eval / pdf per type
# ---------------------------------------------------------------------------

def _eval_diffuse(p, wi, wo):
    """src/bsdfs/diffuse.cpp"""
    ok = (wi.z > 0) & (wo.z > 0)
    val = p.refl * (INV_PI * torch.clamp_min(wo.z, 0.0))
    return _m3(ok, val)


def _pdf_diffuse(p, wi, wo):
    ok = (wi.z > 0) & (wo.z > 0)
    return torch.where(ok, v.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _eval_roughdiffuse(p, wi, wo):
    """Oren-Nayar (src/bsdfs/roughdiffuse.cpp, full model); sigma is alpha
    times the reference's 1/sqrt(2)."""
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    sigma = p.alpha_u * 0.70711
    s2 = sigma * sigma
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    B = 0.45 * s2 / (s2 + 0.09)
    i_lt_o = ci < co
    sin_a = torch.where(i_lt_o, v.sin_theta(wi), v.sin_theta(wo))
    tan_b = torch.where(i_lt_o, v.tan_theta(wo), v.tan_theta(wi))
    cpd = v.cos_phi(wi) * v.cos_phi(wo) + v.sin_phi(wi) * v.sin_phi(wo)
    val = p.refl * (
        INV_PI * co * (A + B * torch.clamp_min(cpd, 0.0) * sin_a * tan_b))
    return _m3(ok, val)


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


def _rough_dielectric_halfvec(p, wi, wo):
    """Walter et al.'s generalized half vector, on wi's side of the IOR
    step (reference eval.py:133)."""
    ci = wi.z
    reflecting = ci * wo.z > 0
    eta_i = torch.where(ci > 0, 1.0, p.eta_s)
    eta_o = torch.where(ci > 0, p.eta_s, 1.0)
    h_r = wi + wo
    h_t = -(wi * eta_i + wo * eta_o)
    h = v.where(reflecting, h_r, h_t).normalized()
    h = h * torch.where(h.z < 0, -1.0, 1.0)
    return h, reflecting, eta_i, eta_o


def _eval_roughdielectric(p, wi, wo):
    """src/bsdfs/roughdielectric.cpp (Walter et al. 2007), radiance mode."""
    ci, co = wi.z, wo.z
    h, reflecting, eta_i, eta_o = _rough_dielectric_halfvec(p, wi, wo)
    D = mf.ndf_v(p.dist, h, p.alpha_u, p.alpha_v)
    G = mf.smith_g2_v(p.dist, wi, wo, h, p.alpha_u, p.alpha_v)
    F = fresnel_dielectric(wi.dot(h), p.eta_s)[0]
    val_r = p.spec * (F * D * G / torch.clamp_min(4.0 * torch.abs(ci), 1e-8))
    wih = wi.dot(h)
    woh = wo.dot(h)
    sqrt_denom = eta_i * wih + eta_o * woh
    # radiance solid-angle compression: (1/eta_crossing)^2
    eta_rel = eta_o / eta_i
    factor = (1.0 / eta_rel) ** 2
    val_t_scalar = (
        torch.abs(wih * woh / torch.clamp_min(torch.abs(ci * co), 1e-8))
        * (eta_o * eta_o * (1.0 - F) * D * G)
        / torch.clamp_min(sqrt_denom * sqrt_denom, 1e-12)
        * factor
        * torch.abs(co))
    val_t = p.trans * val_t_scalar
    valid = (D > 0) & (torch.abs(ci) > 1e-7)
    return _m3(valid, v.where(reflecting, val_r, val_t))


def _pdf_roughdielectric(p, wi, wo):
    h, reflecting, eta_i, eta_o = _rough_dielectric_halfvec(p, wi, wo)
    wi_up = v.where(wi.z < 0, -wi, wi)
    pm = mf.pdf_visible_v(p.dist, wi_up, h, p.alpha_u, p.alpha_v)
    F = fresnel_dielectric(wi.dot(h), p.eta_s)[0]
    prob = torch.where(reflecting, F, 1.0 - F)
    woh = wo.dot(h)
    wih = wi.dot(h)
    # reflection keeps wi, wo on one side of h, transmission crosses it
    valid = torch.where(reflecting, wih * woh > 0, wih * woh < 0)
    sqrt_denom = eta_i * wih + eta_o * woh
    jac_r = 1.0 / torch.clamp_min(4.0 * torch.abs(woh), 1e-8)
    jac_t = (eta_o * eta_o * torch.abs(woh)) / torch.clamp_min(
        sqrt_denom * sqrt_denom, 1e-12)
    jac = torch.where(reflecting, jac_r, jac_t)
    return torch.where(valid, torch.clamp_min(pm * prob * jac, 0.0), 0.0)


def _plastic_terms(p, wi, wo):
    """src/bsdfs/plastic.cpp diffuse term (nonlinear = false)."""
    ci, co = wi.z, wo.z
    Fi = fresnel_dielectric(ci, p.eta_s)[0]
    Fo = fresnel_dielectric(co, p.eta_s)[0]
    fdr_int = fresnel_diffuse_reflectance(1.0 / p.eta_s)
    inv_eta2 = 1.0 / (p.eta_s * p.eta_s)
    diff = p.refl * (1.0 / torch.clamp_min(1.0 - fdr_int, 1e-6))
    return diff * (INV_PI * torch.clamp_min(co, 0.0) * inv_eta2
                   * (1.0 - Fi) * (1.0 - Fo))


def _spec_sampling_weight(p):
    s = p.spec.mean()
    d = p.refl.mean()
    return s / torch.clamp_min(s + d, 1e-8)


def _prob_specular(p, Fi):
    sw = _spec_sampling_weight(p)
    ps = Fi * sw
    pd = (1.0 - Fi) * (1.0 - sw)
    return ps / torch.clamp_min(ps + pd, 1e-8)


def _coat_cos_inside(c, eta):
    """Refracted cosine inside the coat: sin' = sin/eta."""
    return safe_sqrt(1.0 - (1.0 - c * c) / (eta * eta))


def _eval_coating(p, wi, wo):
    """Smooth dielectric coating over a diffuse substrate
    (``src/bsdfs/coating.cpp``): both directions refract into the coat,
    Beer absorption exp(-sigma_a d (1/cos_i' + 1/cos_o')) on both
    crossings, 1/eta^2 from the solid-angle compression."""
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    eta = p.eta_s
    F_i = fresnel_dielectric(ci, eta)[0]
    F_o = fresnel_dielectric(co, eta)[0]
    ci_p = torch.clamp_min(_coat_cos_inside(ci, eta), 1e-6)
    co_p = torch.clamp_min(_coat_cos_inside(co, eta), 1e-6)
    absorption = (p.trans * (-(1.0 / ci_p + 1.0 / co_p))).exp()
    scale = (INV_PI * torch.clamp_min(co, 0.0) * (1.0 - F_i) * (1.0 - F_o)
             / (eta * eta))
    return _m3(ok, p.refl * absorption * scale)


def _pdf_coating(p, wi, wo):
    """Cosine sampling inside the coat pushed through the exit refraction,
    times the substrate lobe's probability 1 - F(wi)."""
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    F_i = fresnel_dielectric(ci, p.eta_s)[0]
    return torch.where(ok, (1.0 - F_i) * torch.clamp_min(co, 0.0)
                       * INV_PI / (p.eta_s * p.eta_s), 0.0)


def _eval_plastic(p, wi, wo):
    ok = (wi.z > 0) & (wo.z > 0)
    return _m3(ok, _plastic_terms(p, wi, wo))


def _pdf_plastic(p, wi, wo):
    ok = (wi.z > 0) & (wo.z > 0)
    Fi = fresnel_dielectric(wi.z, p.eta_s)[0]
    prob_spec = _prob_specular(p, Fi)
    return torch.where(
        ok, v.square_to_cosine_hemisphere_pdf(wo) * (1.0 - prob_spec), 0.0)


def _prob_specular_rough(p, ci):
    """roughplastic's lobe-selection probability: 1 - T(ct) mixed with the
    reflectance-based sampling weight (roughplastic.cpp:414-421)."""
    alpha = 0.5 * (p.alpha_u + p.alpha_v)
    ps = 1.0 - rtrans_eval_v(p.dist, torch.clamp_min(ci, 0.0), alpha,
                             p.eta_s)
    sw = _spec_sampling_weight(p)
    num = ps * sw
    return num / torch.clamp_min(num + (1.0 - ps) * (1.0 - sw), 1e-8)


def _eval_roughplastic(p, wi, wo):
    """src/bsdfs/roughplastic.cpp: a microfacet specular lobe and a diffuse
    term attenuated by the rough transmittance tables, with the internal
    scattering's Fdr correction."""
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    h = (wi + wo).normalized()
    D = mf.ndf_v(p.dist, h, p.alpha_u, p.alpha_v)
    G = mf.smith_g2_v(p.dist, wi, wo, h, p.alpha_u, p.alpha_v)
    F = fresnel_dielectric(wi.dot(h), p.eta_s)[0]
    spec = p.spec * (F * D * G / torch.clamp_min(4.0 * ci, 1e-8))
    alpha = 0.5 * (p.alpha_u + p.alpha_v)
    T12 = rtrans_eval_v(p.dist, torch.clamp_min(ci, 0.0), alpha, p.eta_s)
    T21 = rtrans_eval_v(p.dist, torch.clamp_min(co, 0.0), alpha, p.eta_s)
    fdr = 1.0 - rtrans_diffuse_v(p.dist, alpha,
                                 1.0 / torch.clamp_min(p.eta_s, 1e-6))
    inv_eta2 = 1.0 / (p.eta_s * p.eta_s)
    diff = (p.refl * (1.0 / torch.clamp_min(1.0 - fdr, 1e-6))
            * (INV_PI * torch.clamp_min(co, 0.0) * inv_eta2 * T12 * T21))
    return _m3(ok, spec + diff)


def _pdf_roughplastic(p, wi, wo):
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    h = (wi + wo).normalized()
    prob_spec = _prob_specular_rough(p, ci)
    pm = mf.pdf_visible_v(p.dist, wi, h, p.alpha_u, p.alpha_v)
    pdf_s = pm / torch.clamp_min(4.0 * torch.abs(wo.dot(h)), 1e-8)
    pdf_d = v.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(ok, prob_spec * pdf_s + (1.0 - prob_spec) * pdf_d,
                       0.0)


def _eval_phong(p, wi, wo):
    """src/bsdfs/phong.cpp: modified Phong = diffuse + (n+2)/2pi cos^n."""
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    alpha = wo.dot(v.reflect(wi))
    n = p.exponent
    spec = p.spec * (
        torch.where(alpha > 0, torch.pow(torch.clamp_min(alpha, 1e-12), n),
                    0.0)
        * (n + 2.0) * (0.5 * INV_PI) * co)
    diff = p.refl * (INV_PI * co)
    return _m3(ok, spec + diff)


def _pdf_phong(p, wi, wo):
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    sw = _spec_sampling_weight(p)
    alpha = torch.clamp_min(wo.dot(v.reflect(wi)), 0.0)
    n = p.exponent
    pdf_s = torch.pow(torch.clamp_min(alpha, 1e-12), n) * (n + 1.0) \
        * (0.5 * INV_PI)
    pdf_s = torch.where(alpha > 0, pdf_s, 0.0)
    pdf_d = v.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(ok, sw * pdf_s + (1.0 - sw) * pdf_d, 0.0)


def _eval_ward(p, wi, wo):
    """src/bsdfs/ward.cpp (balanced variant)."""
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    h = wi + wo
    au, av = p.alpha_u, p.alpha_v
    exp_arg = -((h.x / au) ** 2 + (h.y / av) ** 2) / torch.clamp_min(
        h.z ** 2, 1e-12)
    # safe_sqrt: a masked lane's negative ci co gives 0 (the reference's
    # NaN), so no NaN meets its zero cotangent
    spec_scalar = torch.exp(exp_arg) / (
        4.0 * PI * au * av * torch.clamp_min(safe_sqrt(ci * co), 1e-8))
    spec = p.spec * (spec_scalar * co)
    diff = p.refl * (INV_PI * co)
    return _m3(ok, spec + diff)


def _pdf_ward(p, wi, wo):
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    sw = _spec_sampling_weight(p)
    h = (wi + wo).normalized()
    au, av = p.alpha_u, p.alpha_v
    exp_arg = -v.tan_theta2(h) * (
        v.cos_phi(h) ** 2 / (au * au) + v.sin_phi(h) ** 2 / (av * av))
    pdf_h = torch.exp(exp_arg) / (
        PI * au * av * torch.clamp_min(h.z ** 3, 1e-8))
    pdf_s = pdf_h / torch.clamp_min(4.0 * torch.abs(wo.dot(h)), 1e-8)
    pdf_d = v.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(ok, sw * pdf_s + (1.0 - sw) * pdf_d, 0.0)


def _eval_difftrans(p, wi, wo):
    """src/bsdfs/difftrans.cpp"""
    opposite = wi.z * wo.z < 0
    return _m3(opposite, p.trans * (INV_PI * torch.abs(wo.z)))


def _pdf_difftrans(p, wi, wo):
    opposite = wi.z * wo.z < 0
    return torch.where(opposite, torch.abs(wo.z) * INV_PI, 0.0)


def _hg_phase(g, cos_t):
    denom = 1.0 + g * g - 2.0 * g * cos_t
    return (0.25 * INV_PI) * (1.0 - g * g) / torch.clamp_min(
        denom * safe_sqrt(denom), 1e-8)


def _hk_pdelta(p, ci):
    """Probability of the attenuated straight-through delta lobe."""
    att = (p.trans * (-1.0 / torch.clamp_min(ci, 1e-4))).exp()
    return torch.clamp(att.mean(), 0.0, 0.95)


def _eval_hk(p, wi, wo):
    """src/bsdfs/hk.cpp (Hanrahan-Krueger 1993): single scattering in a slab
    of optical depth tau (``trans``), single-scattering albedo (``refl``)
    and HG phase of asymmetry g (``alpha_u``); the smooth reflection and
    transmission terms (the attenuated delta transmission is sampled
    only)."""
    ci = torch.clamp_min(torch.abs(wi.z), 1e-4)
    co = torch.clamp_min(torch.abs(wo.z), 1e-4)
    same = wi.z * wo.z > 0
    tau = p.trans
    ph = _hg_phase(p.alpha_u, -wi.dot(wo))
    # reflection: alpha p / (ci + co) (1 - e^{-tau (1/ci + 1/co)})
    one_m = 1.0 - (tau * (-(1.0 / ci + 1.0 / co))).exp()
    fr = p.refl * ph * one_m * (1.0 / (ci + co))
    # transmission: alpha p (e^{-tau/ci} - e^{-tau/co}) / (ci - co), with
    # the ci -> co limit alpha p tau / ci^2 e^{-tau/ci}
    dm = ci - co
    e_ci = (tau * (-1.0 / ci)).exp()
    e_co = (tau * (-1.0 / co)).exp()
    small_dm = torch.abs(dm) < 1e-5
    ft_reg = (e_ci - e_co) * (1.0 / torch.where(small_dm, 1.0, dm))
    ft_lim = tau * (1.0 / (ci * ci)) * e_ci
    ft = p.refl * ph * v.where(small_dm, ft_lim, ft_reg)
    return (v.where(same, fr, ft) * co).clamp_min(0.0)


def _pdf_hk(p, wi, wo):
    pd = _hk_pdelta(p, torch.abs(wi.z))
    return (1.0 - pd) * 0.5 * torch.abs(wo.z) * INV_PI


_EVAL = {
    DIFFUSE: (_eval_diffuse, _pdf_diffuse),
    ROUGHDIFFUSE: (_eval_roughdiffuse, _pdf_diffuse),
    ROUGHCONDUCTOR: (_eval_roughconductor, _pdf_roughconductor),
    ROUGHDIELECTRIC: (_eval_roughdielectric, _pdf_roughdielectric),
    PLASTIC: (_eval_plastic, _pdf_plastic),
    COATING: (_eval_coating, _pdf_coating),
    ROUGHPLASTIC: (_eval_roughplastic, _pdf_roughplastic),
    PHONG: (_eval_phong, _pdf_phong),
    WARD: (_eval_ward, _pdf_ward),
    DIFFTRANS: (_eval_difftrans, _pdf_difftrans),
    HK: (_eval_hk, _pdf_hk),
}


def bsdf_eval_v(p: LaneParams3, wi: V3, wo: V3) -> V3:
    """f(wi, wo) * |cos_theta_o| over smooth components (delta types: 0)."""
    _check_types(p)
    wi, wo, _ = _maybe_flip(p, wi, wo)
    out = v.zeros(p.type.shape, p.type.device)
    for t in p.used_types:
        if t in _EVAL:
            out = v.where(p.type == t, _EVAL[t][0](p, wi, wo), out)
    return out


def bsdf_pdf_v(p: LaneParams3, wi: V3, wo: V3) -> torch.Tensor:
    """Solid-angle pdf of bsdf_sample landing at wo (smooth components)."""
    _check_types(p)
    wi, wo, _ = _maybe_flip(p, wi, wo)
    out = torch.zeros(p.type.shape, dtype=Float, device=p.type.device)
    for t in p.used_types:
        if t in _EVAL:
            out = torch.where(p.type == t, _EVAL[t][1](p, wi, wo), out)
    return out


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _sample_smooth_family(t, p, wi, ci, u_lobe, u2a, u2b):
    """Types sampled by 'draw a direction, weight = eval/pdf' (and PLASTIC,
    whose specular lobe is a delta): (wo, weight, pdf, delta, eta)."""
    shape, dev = ci.shape, ci.device
    no = torch.zeros(shape, dtype=torch.bool, device=dev)
    one = torch.ones(shape, dtype=Float, device=dev)
    if t == ROUGHCONDUCTOR:
        h, _ = mf.sample_visible_v(p.dist, wi, p.alpha_u, p.alpha_v, u2a, u2b)
        wo = v.reflect_n(wi, h).normalized()
    elif t == ROUGHDIELECTRIC:
        wi_up = v.where(ci < 0, -wi, wi)
        h, _ = mf.sample_visible_v(p.dist, wi_up, p.alpha_u, p.alpha_v,
                                   u2a, u2b)
        c = wi.dot(h)
        F, cos_t, eta_rel, eta_ti = fresnel_dielectric(c, p.eta_s)
        refl = u_lobe < F
        wo_r = v.reflect_n(wi, h).normalized()
        wo_t = (h * (eta_ti * c + cos_t) - wi * eta_ti).normalized()
        wo = v.where(refl, wo_r, wo_t)
        # hemisphere rejection as in roughdielectric.cpp: reflection stays
        # on wi's side, transmission crosses
        same_side = wi.z * wo.z > 0
        side_ok = torch.where(refl, same_side, ~same_side)
        pdf = _pdf_roughdielectric(p, wi, wo)
        w = _over_pdf((pdf > 1e-12) & side_ok,
                      _eval_roughdielectric(p, wi, wo), pdf)
        eta_out = torch.where(refl, 1.0, eta_rel)
        return wo, w, torch.clamp_min(pdf, 1e-20), no, eta_out
    elif t in (PLASTIC, ROUGHPLASTIC):
        Fi = fresnel_dielectric(ci, p.eta_s)[0]
        if t == ROUGHPLASTIC:
            prob_spec = _prob_specular_rough(p, ci)
        else:
            prob_spec = _prob_specular(p, Fi)
        pick_spec = u_lobe < prob_spec
        wo_d = v.square_to_cosine_hemisphere(u2a, u2b)
        if t == PLASTIC:  # the specular lobe is a delta
            w_spec = p.spec * (Fi / torch.clamp_min(prob_spec, 1e-8))
            pdf_d = v.square_to_cosine_hemisphere_pdf(wo_d) * (1.0 - prob_spec)
            w_diff = _eval_plastic(p, wi, wo_d) * safe_div(1.0, pdf_d)
            wo = v.where(pick_spec, v.reflect(wi), wo_d)
            w = v.where(pick_spec, w_spec, w_diff)
            pdf = torch.where(pick_spec, 1.0, torch.clamp_min(pdf_d, 1e-20))
            valid = (ci > 0) & (pick_spec | (pdf > 1e-12))
            return wo, _m3(valid, w), pdf, pick_spec, one
        h, _ = mf.sample_visible_v(p.dist, wi, p.alpha_u, p.alpha_v, u2a, u2b)
        wo_s = v.reflect_n(wi, h).normalized()
        wo = v.where(pick_spec, wo_s, wo_d)
    elif t == PHONG:
        pick_spec = u_lobe < _spec_sampling_weight(p)
        n = p.exponent
        ct = torch.pow(torch.clamp_min(u2a, 1e-20), 1.0 / (n + 1.0))
        st = safe_sqrt(1.0 - ct * ct)
        phi = 2.0 * PI * u2b
        local = V3(st * torch.cos(phi), st * torch.sin(phi), ct)
        fr = v.frame_from_normal(v.reflect(wi).normalized())
        wo_s = v.to_world(fr, local)
        wo = v.where(pick_spec, wo_s, v.square_to_cosine_hemisphere(u2a, u2b))
    elif t == WARD:
        pick_spec = u_lobe < _spec_sampling_weight(p)
        au, av = p.alpha_u, p.alpha_v
        phi_h = torch.atan2(av * torch.sin(2 * PI * u2b),
                            au * torch.cos(2 * PI * u2b))
        cp, sp = torch.cos(phi_h), torch.sin(phi_h)
        denom = cp * cp / (au * au) + sp * sp / (av * av)
        t2 = -torch.log(torch.clamp_min(u2a, 1e-20)) / torch.clamp_min(
            denom, 1e-12)
        ct = torch.rsqrt(1.0 + t2)
        st = safe_sqrt(1.0 - ct * ct)
        h = V3(st * cp, st * sp, ct)
        wo_s = v.reflect_n(wi, h).normalized()
        wo = v.where(pick_spec, wo_s, v.square_to_cosine_hemisphere(u2a, u2b))
    elif t == DIFFTRANS:  # cosine hemisphere on the side opposite wi
        base = v.square_to_cosine_hemisphere(u2a, u2b)
        wo = V3(base.x, base.y, base.z * torch.where(ci > 0, -1.0, 1.0))
    else:
        raise AssertionError(t)
    evf, pdff = _EVAL[t]
    pdf = pdff(p, wi, wo)
    w = _over_pdf(pdf > 1e-12, evf(p, wi, wo), pdf)
    return wo, w, torch.clamp_min(pdf, 1e-20), no, one


def bsdf_sample_v(p: LaneParams3, wi: V3, u_lobe, u2a, u2b) -> BSDFSample3:
    """Importance-sample the BSDF: ``u_lobe`` picks lobes, (u2a, u2b) drive
    the directional warp.  (The reference's fourth uniform decides mask
    opacity, which is 1 without the MASK wrapper.)"""
    _check_types(p)
    wi_f, flip = _maybe_flip(p, wi)
    shape, dev = p.type.shape, p.type.device
    zero = torch.zeros(shape, dtype=Float, device=dev)
    one = torch.ones(shape, dtype=Float, device=dev)
    yes = torch.ones(shape, dtype=torch.bool, device=dev)
    no = torch.zeros(shape, dtype=torch.bool, device=dev)
    out = (V3(zero, zero, one), v.zeros(shape, dev), zero, no, one)
    ci = wi_f.z

    for t in p.used_types:
        if t in (DIFFUSE, ROUGHDIFFUSE):
            wo_t = v.square_to_cosine_hemisphere(u2a, u2b)
            pdf_t = v.square_to_cosine_hemisphere_pdf(wo_t)
            if t == DIFFUSE:
                w_t = _m3(ci > 0, p.refl)
            else:
                w_t = _eval_roughdiffuse(p, wi_f, wo_t) * safe_div(1.0, pdf_t)
            new = (wo_t, w_t, pdf_t, no, one)
        elif t == CONDUCTOR:
            F = fresnel_conductor_v(ci, p.eta, p.k)
            new = (v.reflect(wi_f), _m3(ci > 0, p.spec * F), one, yes, one)
        elif t in (ROUGHCONDUCTOR, ROUGHDIELECTRIC, ROUGHPLASTIC, PLASTIC,
                   PHONG, WARD, DIFFTRANS):
            new = _sample_smooth_family(t, p, wi_f, ci, u_lobe, u2a, u2b)
        elif t == COATING:
            # specular reflection with probability F(wi), else a cosine
            # sample inside the coat refracted back out (exit-TIR samples
            # are lost, as in the reference)
            eta_c = p.eta_s
            F_i = fresnel_dielectric(ci, eta_c)[0]
            pick_spec = u_lobe < F_i
            wo_in = v.square_to_cosine_hemisphere(u2a, u2b)
            tz2 = 1.0 - eta_c * eta_c * (1.0 - wo_in.z * wo_in.z)
            exits = tz2 > 0.0
            wo_sub = V3(eta_c * wo_in.x, eta_c * wo_in.y,
                        safe_sqrt(tz2)).normalized()
            co = torch.clamp_min(wo_sub.z, 1e-6)
            F_o = fresnel_dielectric(co, eta_c)[0]
            ci_p = torch.clamp_min(_coat_cos_inside(ci, eta_c), 1e-6)
            absorption = (p.trans * (-(1.0 / ci_p + 1.0 / wo_in.z))).exp()
            w_sub = _m3((ci > 0) & exits, p.refl * absorption * (1.0 - F_o))
            pdf_sub = torch.where(
                exits, (1.0 - F_i) * co * INV_PI / (eta_c * eta_c), 1.0)
            new = (v.where(pick_spec, v.reflect(wi_f), wo_sub),
                   v.where(pick_spec, p.spec, w_sub),
                   torch.where(pick_spec, 1.0, pdf_sub), pick_spec, one)
        elif t == DIELECTRIC:
            F, cos_t, eta_rel, eta_ti = fresnel_dielectric(ci, p.eta_s)
            refl = u_lobe < F
            n_up = V3(zero, zero, one)
            wo_t = v.refract_n(wi_f, n_up, eta_ti, cos_t).normalized()
            new = (v.where(refl, v.reflect(wi_f), wo_t),
                   v.where(refl, p.spec, p.trans * (eta_ti * eta_ti)),
                   one, yes, torch.where(refl, 1.0, eta_rel))
        elif t == THINDIELECTRIC:  # no bend: straight through or mirror
            F = fresnel_dielectric(torch.abs(ci), p.eta_s)[0]
            R = torch.where(F < 1.0, 2.0 * F / (1.0 + F), 1.0)
            refl = u_lobe < R
            new = (v.where(refl, v.reflect(wi_f), -wi_f),
                   v.where(refl, p.spec, p.trans), one, yes, one)
        elif t == HK:
            # delta transmission against cosine-sampled single scattering
            aci = torch.clamp_min(torch.abs(ci), 1e-4)
            pd = _hk_pdelta(p, aci)
            pick_delta = u_lobe < pd
            u_re = torch.clamp((u_lobe - pd) / torch.clamp_min(1.0 - pd, 1e-8),
                               0.0, 0.999999)
            down = u_re < 0.5  # the transmission side
            base = v.square_to_cosine_hemisphere(u2a, u2b)
            sgn = torch.where(down, -torch.sign(ci), torch.sign(ci))
            wo_s = V3(base.x, base.y, base.z * sgn)
            pdf_s = (1.0 - pd) * 0.5 * torch.abs(wo_s.z) * INV_PI
            w_s = _eval_hk(p, wi_f, wo_s) * safe_div(1.0, pdf_s)
            w_d = (p.trans * (-1.0 / aci)).exp() * (
                1.0 / torch.clamp_min(pd, 1e-8))
            new = (v.where(pick_delta, -wi_f, wo_s),
                   v.where(pick_delta, w_d, w_s),
                   torch.where(pick_delta, 1.0, torch.clamp_min(pdf_s, 1e-20)),
                   pick_delta, one)
        else:  # NULL_BSDF
            new = (-wi_f, v.ones(shape, dev), one, yes, one)
        sel = p.type == t
        out = tuple(v.where(sel, a, b) if isinstance(a, V3)
                    else torch.where(sel, a, b) for a, b in zip(new, out))

    wo, weight, pdf, delta, eta = out
    null_pass = (p.type == NULL_BSDF) if NULL_BSDF in p.used_types else no
    # un-flip for twosided lanes
    fz = torch.where(flip, -1.0, 1.0)
    return BSDFSample3(wo=V3(wo.x, wo.y, wo.z * fz), weight=weight, pdf=pdf,
                       delta=delta, eta=eta, null_passthrough=null_pass)
