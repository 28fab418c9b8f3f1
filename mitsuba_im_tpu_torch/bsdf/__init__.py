"""BSDF plugin factories (``mitsuba_im_tpu/bsdf/__init__.py``): each maps a
``Properties`` bag to the parameter record that ``common.build_table``
takes, as the reference's factory does, defaults included.

Nested wrappers fold into flags and links on the inner record
(``twosided``, ``bumpmap``, ``normalmap``) or into MASK and BLEND rows that
the builder links by id (``mask``, ``blendbsdf``, ``mixturebsdf``).  A
texture child arrives as its texture id.  ``coating`` over a substrate
that is not diffuse becomes ``plastic`` over the substrate's colour, and
``roughcoating`` drops the coat's roughness, each with a warning, as in the
reference.  ``irawan`` raises.
"""
from __future__ import annotations

import numpy as np

from ..core.properties import Properties
from ..core.registry import register, register_unported, warn_substitution
from . import common as bc
from .ior import lookup_conductor, lookup_dielectric
from .microfacet import DIST_BECKMANN, DIST_GGX, DIST_PHONG

_DISTS = {"beckmann": DIST_BECKMANN, "ggx": DIST_GGX, "phong": DIST_PHONG,
          "as": DIST_BECKMANN}


def _texture_or_rgb(props: Properties, name, default):
    """(rgb, texture id) of a spectrum parameter that a child texture may
    give instead."""
    if name in props.children:
        return np.zeros(3), props.children[name]
    if name in props:
        return props.get_spectrum(name), -1
    props.get_spectrum(name, np.asarray(default, np.float64))
    return np.asarray(default, np.float64), -1


def _alpha(props: Properties, rec):
    if "alpha" in props.children:
        rec["alpha_tex"] = props.children["alpha"]
        rec["alpha_u"] = rec["alpha_v"] = 0.1
    else:
        a = props.get_float("alpha", 0.1)
        rec["alpha_u"] = props.get_float("alphaU", a)
        rec["alpha_v"] = props.get_float("alphaV", a)
    rec["dist"] = _DISTS.get(props.get_string("distribution", "beckmann"),
                             DIST_BECKMANN)


def _eta_dielectric(props: Properties) -> float:
    int_ior = props.get_float("intIOR", 0.0) if "intIOR" in props else None
    ext_ior = props.get_float("extIOR", 0.0) if "extIOR" in props else None
    if int_ior is None:
        int_ior = lookup_dielectric(props.get_string("intIORMaterial", "bk7"))
    if ext_ior is None:
        ext_ior = lookup_dielectric(props.get_string("extIORMaterial", "air"))
    return float(int_ior) / float(ext_ior)


def _diffuse_factory(type_code):
    def factory(props: Properties, ctx=None):
        rec = bc.default_record()
        rec["type"] = type_code
        rec["refl"], rec["refl_tex"] = _texture_or_rgb(props, "reflectance",
                                                       [0.5] * 3)
        if type_code == bc.ROUGHDIFFUSE:
            rec["alpha_u"] = rec["alpha_v"] = props.get_float("alpha", 0.2)
        return rec

    return factory


register("bsdf", "diffuse")(_diffuse_factory(bc.DIFFUSE))
register("bsdf", "roughdiffuse")(_diffuse_factory(bc.ROUGHDIFFUSE))


@register("bsdf", "conductor")
def _conductor(props: Properties, ctx=None, rough=False):
    rec = bc.default_record()
    rec["type"] = bc.ROUGHCONDUCTOR if rough else bc.CONDUCTOR
    eta, k = lookup_conductor(props.get_string("material", "Cu"))
    if "eta" in props:
        eta = props.get_spectrum("eta")
    if "k" in props:
        k = props.get_spectrum("k")
    ext = props.get_float("extEta", 1.000277)
    rec["eta"] = np.asarray(eta) / ext
    rec["k"] = np.asarray(k) / ext
    rec["spec"], rec["spec_tex"] = _texture_or_rgb(
        props, "specularReflectance", [1.0] * 3)
    if rough:
        _alpha(props, rec)
    return rec


@register("bsdf", "roughconductor")
def _roughconductor(props, ctx=None):
    return _conductor(props, ctx, rough=True)


def _dielectric_factory(type_code):
    def factory(props: Properties, ctx=None):
        rec = bc.default_record()
        rec["type"] = type_code
        rec["eta_s"] = _eta_dielectric(props)
        rec["spec"], rec["spec_tex"] = _texture_or_rgb(
            props, "specularReflectance", [1.0] * 3)
        rec["trans"], rec["trans_tex"] = _texture_or_rgb(
            props, "specularTransmittance", [1.0] * 3)
        if type_code == bc.ROUGHDIELECTRIC:
            _alpha(props, rec)
        return rec

    return factory


register("bsdf", "dielectric")(_dielectric_factory(bc.DIELECTRIC))
register("bsdf", "thindielectric")(_dielectric_factory(bc.THINDIELECTRIC))
register("bsdf", "roughdielectric")(_dielectric_factory(bc.ROUGHDIELECTRIC))


@register("bsdf", "plastic")
def _plastic(props: Properties, ctx=None, rough=False):
    rec = bc.default_record()
    rec["type"] = bc.ROUGHPLASTIC if rough else bc.PLASTIC
    rec["eta_s"] = _eta_dielectric(props)
    rec["refl"], rec["refl_tex"] = _texture_or_rgb(
        props, "diffuseReflectance", [0.5] * 3)
    rec["spec"], rec["spec_tex"] = _texture_or_rgb(
        props, "specularReflectance", [1.0] * 3)
    props.get_bool("nonlinear", False)
    if rough:
        _alpha(props, rec)
    return rec


@register("bsdf", "roughplastic")
def _roughplastic(props, ctx=None):
    return _plastic(props, ctx, rough=True)


@register("bsdf", "coating")
def _coating(props: Properties, ctx=None, rough=False):
    """A smooth dielectric coat over a diffuse-class substrate, one row:
    the substrate's reflectance, sigmaA * thickness in ``trans``."""
    inner = props.children.get("bsdf", None)
    base = dict(inner) if isinstance(inner, dict) else bc.default_record()
    out = bc.default_record()
    out["eta_s"] = _eta_dielectric(props)
    out["refl"] = base.get("refl", np.full(3, 0.5))
    out["refl_tex"] = base.get("refl_tex", -1)
    thickness = props.get_float("thickness", 1.0)
    sigma_a = props.get_spectrum("sigmaA", np.zeros(3))
    out["trans"] = np.asarray(sigma_a, np.float64) * thickness
    out["spec"] = props.get_spectrum("specularReflectance", np.ones(3))
    if base.get("type", bc.DIFFUSE) in (bc.DIFFUSE, bc.ROUGHDIFFUSE):
        out["type"] = bc.COATING
        if base.get("type") == bc.ROUGHDIFFUSE:
            warn_substitution(
                "coating", "rough-diffuse substrate treated as Lambertian "
                "inside the coat (Oren-Nayar term dropped)")
    else:
        out["type"] = bc.PLASTIC
        warn_substitution(
            "coating", "non-diffuse substrate approximated as plastic over "
            "the substrate color (layered eval limited to diffuse bases)")
    if rough:
        warn_substitution(
            "roughcoating", "coat interface treated as smooth (substrate "
            "refraction + absorption are exact; coat roughness dropped)")
    return out


@register("bsdf", "roughcoating")
def _roughcoating(props, ctx=None):
    return _coating(props, ctx, rough=True)


@register("bsdf", "phong")
def _phong(props: Properties, ctx=None):
    rec = bc.default_record()
    rec["type"] = bc.PHONG
    rec["exponent"] = props.get_float("exponent", 30.0)
    rec["refl"], rec["refl_tex"] = _texture_or_rgb(
        props, "diffuseReflectance", [0.5] * 3)
    rec["spec"], rec["spec_tex"] = _texture_or_rgb(
        props, "specularReflectance", [0.2] * 3)
    return rec


@register("bsdf", "ward")
def _ward(props: Properties, ctx=None):
    rec = bc.default_record()
    rec["type"] = bc.WARD
    rec["alpha_u"] = props.get_float("alphaU", props.get_float("alpha", 0.1))
    rec["alpha_v"] = props.get_float("alphaV", props.get_float("alpha", 0.1))
    rec["refl"], rec["refl_tex"] = _texture_or_rgb(
        props, "diffuseReflectance", [0.5] * 3)
    rec["spec"], rec["spec_tex"] = _texture_or_rgb(
        props, "specularReflectance", [0.2] * 3)
    props.get_string("variant", "balanced")
    return rec


@register("bsdf", "null")
def _null(props, ctx=None):
    return bc.null_record()


@register("bsdf", "difftrans")
def _difftrans(props: Properties, ctx=None):
    rec = bc.default_record()
    rec["type"] = bc.DIFFTRANS
    rec["trans"], rec["trans_tex"] = _texture_or_rgb(props, "transmittance",
                                                     [0.5] * 3)
    return rec


@register("bsdf", "twosided")
def _twosided(props: Properties, ctx=None):
    inner = props.children.get("bsdf")
    return bc.twosided(inner if isinstance(inner, dict)
                       else bc.default_record())


@register("bsdf", "mask")
def _mask(props: Properties, ctx=None):
    """An opacity mask over the nested BSDF, which gets its own row."""
    inner = props.children.get("bsdf")
    rec = bc.default_record()
    rec["type"] = bc.MASK
    rec["opacity"], rec["opacity_tex"] = _texture_or_rgb(props, "opacity",
                                                         [0.5] * 3)
    if ctx is not None and isinstance(inner, dict):
        rec["nested"] = ctx.add_bsdf(inner)
    return rec


def _nested_id(ctx, rec):
    if isinstance(rec, (int, np.integer)):
        return int(rec)
    return ctx.add_bsdf(rec if isinstance(rec, dict) else bc.default_record())


def _blend_record(ctx, rec_a, rec_b, weight, weight_tex=-1):
    """One BLEND row taking ``rec_b`` with probability ``weight``."""
    out = bc.default_record()
    out["type"] = bc.BLEND
    out["weight"] = float(np.clip(weight, 0.0, 1.0))
    out["weight_tex"] = weight_tex
    if ctx is not None:
        out["nested"] = _nested_id(ctx, rec_a)
        out["nested2"] = _nested_id(ctx, rec_b)
    return out


@register("bsdf", "blendbsdf")
def _blend(props: Properties, ctx=None):
    w = props.get_float("weight", 0.5)
    wtex = props.children.get("weight", -1)
    if not isinstance(wtex, (int, np.integer)):
        wtex = -1
    inners = props.children.get("bsdf_list", [])
    if len(inners) >= 2:
        return _blend_record(ctx, inners[0], inners[1], w, int(wtex))
    if inners:
        return dict(inners[0])
    return bc.default_record()


@register("bsdf", "mixturebsdf")
def _mixture(props: Properties, ctx=None):
    """An N-way mixture folded into a chain of BLEND rows; a weight sum
    below 1 blends the rest against a black absorber."""
    weights = [float(x) for x in props.get_string("weights", "1").split(",")]
    inners = props.children.get("bsdf_list", [])
    if not inners:
        return bc.default_record()
    if len(inners) == 1:
        return dict(inners[0])
    weights = weights[: len(inners)] + [1.0] * (len(inners) - len(weights))
    total = sum(weights)
    acc = dict(inners[0])
    acc_w = weights[0]
    for nxt, w_n in zip(inners[1:], weights[1:]):
        acc = _blend_record(ctx, acc, nxt, w_n / max(acc_w + w_n, 1e-8))
        acc_w += w_n
    if total < 0.999:
        black = bc.default_record()
        black["refl"] = np.zeros(3)
        acc = _blend_record(ctx, black, acc, total)
    return acc


def _wrap_bump(props: Properties, kind):
    inner = props.children.get("bsdf")
    rec = dict(inner) if isinstance(inner, dict) else bc.default_record()
    tex = props.children.get("texture",
                             props.children.get("map",
                                                props.children.get("normals")))
    if isinstance(tex, (int, np.integer)):
        rec = bc.bump(rec, int(tex), kind, props.get_float("scale", 1.0))
    return rec


@register("bsdf", "bumpmap")
def _bumpmap(props: Properties, ctx=None):
    return _wrap_bump(props, bc.BUMP_HEIGHT)


@register("bsdf", "normalmap")
def _normalmap(props: Properties, ctx=None):
    return _wrap_bump(props, bc.BUMP_NORMAL)


@register("bsdf", "hk")
def _hk(props: Properties, ctx=None):
    """Hanrahan-Krueger: albedo in ``refl``, optical depth in ``trans``, the
    phase child's HG asymmetry g in ``alpha_u``/``alpha_v``."""
    thickness = props.get_float("thickness", 1.0)
    if "sigmaS" in props or "sigmaA" in props:
        kw = dict(sigma_s=props.get_spectrum("sigmaS", np.full(3, 2.0)),
                  sigma_a=props.get_spectrum("sigmaA", np.full(3, 0.05)))
    elif "sigmaT" in props:
        kw = dict(sigma_t=props.get_spectrum("sigmaT"),
                  albedo=props.get_spectrum("albedo", np.full(3, 0.8)))
    else:
        kw = {}
    phase = props.children.get("phase", dict(g=0.0))
    g = float(phase.get("g", 0.0)) if isinstance(phase, dict) else 0.0
    return bc.hk_record(thickness=thickness, g=g, **kw)


# the phase functions an ``hk`` layer reads its asymmetry from (the
# reference's ``media/__init__.py`` records; the media themselves and the
# other phase functions are not ported, see ``integrators/__init__.py``)
PH_ISOTROPIC, PH_HG = 0, 1


@register("phase", "isotropic")
def _isotropic(props: Properties, ctx=None):
    return dict(type=PH_ISOTROPIC, g=0.0)


@register("phase", "hg")
def _hg(props: Properties, ctx=None):
    return dict(type=PH_HG, g=props.get_float("g", 0.8))


register_unported("bsdf", ("irawan",), "queue A item 2")
