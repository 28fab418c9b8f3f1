"""BSDF parameter tables and per-lane resolution
(``mitsuba_im_tpu/bsdf/common.py``), for untextured records, and the
record factories of the ported types (``mitsuba_im_tpu/bsdf/__init__.py``,
taking keyword arguments where the reference reads a ``Properties`` bag).

Each scene BSDF is one row of typed parameters; lanes gather their row into
a :class:`LaneParams3` through the one row lookup ``v3.gather_row``.
Texture references, MASK/BLEND unwrapping, bump mapping and IRAWAN are not
ported yet and raise.

HK keeps its Henyey-Greenstein asymmetry g in ``alpha_u``.  The reference
clamps every ``alpha_u``/``alpha_v`` to at least 1e-4 in ``resolve_v``,
which turns a back-scattering HK layer (g < 0) into g = 1e-4 (ROADMAP C7);
``hk.cpp`` allows g anywhere in (-1, 1).  The port clamps the roughness of
every other type and passes HK's g through unclamped.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import INVALID, host_tensor
from ..core import v3 as v
from ..core.v3 import V3
from .ior import lookup_conductor, lookup_dielectric
from .microfacet import DIST_BECKMANN, DIST_GGX, DIST_PHONG

# Type codes (one per reference bsdf plugin)
DIFFUSE = 0
ROUGHDIFFUSE = 1
CONDUCTOR = 2
ROUGHCONDUCTOR = 3
DIELECTRIC = 4
THINDIELECTRIC = 5
ROUGHDIELECTRIC = 6
PLASTIC = 7
ROUGHPLASTIC = 8
PHONG = 9
WARD = 10
NULL_BSDF = 11
DIFFTRANS = 12
COATING = 13
MASK = 14
BLEND = 15
BUMPMAP_WRAP = 16
HK = 17
IRAWAN = 18

BUMP_NONE = 0
FLAG_TWOSIDED = 1

_DISTS = {"beckmann": DIST_BECKMANN, "ggx": DIST_GGX, "phong": DIST_PHONG,
          "as": DIST_BECKMANN}

TEXTURE_COLUMNS = ("refl_tex", "spec_tex", "trans_tex", "alpha_tex",
                   "opacity_tex", "weight_tex", "bump_tex")


@dataclasses.dataclass(frozen=True)
class BSDFTable:
    """The columns the ported BSDFs read; the reference's other columns
    (opacity, wrapper links, bump maps) join with the wrappers."""

    type: torch.Tensor  # (B,) int32
    dist: torch.Tensor  # (B,) int32 microfacet distribution
    refl: torch.Tensor  # (B, 3) diffuse reflectance (HK: albedo)
    spec: torch.Tensor  # (B, 3) specular reflectance
    trans: torch.Tensor  # (B, 3) transmittance (coating: sigma_a d, HK: tau)
    eta: torch.Tensor  # (B, 3) conductor ior (rgb)
    k: torch.Tensor  # (B, 3) conductor absorption
    eta_s: torch.Tensor  # (B,) dielectric relative ior (int / ext)
    alpha_u: torch.Tensor  # (B,) roughness (HK: the HG asymmetry g)
    alpha_v: torch.Tensor  # (B,)
    exponent: torch.Tensor  # (B,) phong exponent
    flags: torch.Tensor  # (B,) int32 (twosided)
    used_types: tuple = (DIFFUSE,)
    unwrap_depth: int = 0  # MASK/BLEND nesting budget
    has_bump: bool = False
    textured: bool = False  # some texture column != INVALID


BSDF_LEAVES = ("type", "dist", "refl", "spec", "trans", "eta", "k", "eta_s",
               "alpha_u", "alpha_v", "exponent", "flags")
# The types that read each of these columns; resolve_v gathers a column
# only when a used type reads it, so a scene without those types pays no
# gather (nor its backward) for it.
_READERS = {
    "trans": (DIELECTRIC, THINDIELECTRIC, ROUGHDIELECTRIC, DIFFTRANS,
              COATING, HK),
    "eta_s": (DIELECTRIC, THINDIELECTRIC, ROUGHDIELECTRIC, PLASTIC,
              ROUGHPLASTIC, COATING),
    "exponent": (PHONG,),
}
_INT_LEAVES = ("type", "dist", "flags")


def default_record() -> dict:
    return dict(
        type=DIFFUSE, dist=DIST_BECKMANN,
        refl=np.full(3, 0.5), refl_tex=INVALID,
        spec=np.ones(3), spec_tex=INVALID,
        trans=np.ones(3), trans_tex=INVALID,
        eta=np.zeros(3), k=np.ones(3), eta_s=1.5046,
        alpha_u=0.1, alpha_v=0.1, alpha_tex=INVALID,
        exponent=30.0,
        opacity=np.full(3, 0.5), opacity_tex=INVALID,
        flags=0, nested=INVALID, nested2=INVALID,
        weight=0.5, weight_tex=INVALID,
        bump_tex=INVALID, bump_kind=BUMP_NONE, bump_scale=1.0,
    )


def conductor_record(material: str = "Cu", ext_eta: float = 1.000277,
                     rough: bool = False, alpha: float = 0.1,
                     alpha_u: float | None = None,
                     alpha_v: float | None = None,
                     distribution: str = "beckmann") -> dict:
    """A ``conductor`` / ``roughconductor`` record, as the reference's
    plugin factory builds it from its properties (defaults included): eta
    and k of the named material divided by the exterior IOR, unit
    specular reflectance."""
    rec = default_record()
    rec["type"] = ROUGHCONDUCTOR if rough else CONDUCTOR
    eta, k = lookup_conductor(material)
    rec["eta"] = eta / ext_eta
    rec["k"] = k / ext_eta
    rec["spec"] = np.ones(3)
    if rough:
        _set_alpha(rec, alpha, alpha_u, alpha_v, distribution)
    return rec


def _rgb(value) -> np.ndarray:
    return np.broadcast_to(np.asarray(value, np.float64), (3,)).copy()


def _eta(int_ior, ext_ior) -> float:
    """int/ext relative IOR; each a number or a named dielectric."""
    if isinstance(int_ior, str):
        int_ior = lookup_dielectric(int_ior)
    if isinstance(ext_ior, str):
        ext_ior = lookup_dielectric(ext_ior)
    return float(int_ior) / float(ext_ior)


def _set_alpha(rec: dict, alpha, alpha_u, alpha_v, distribution):
    rec["alpha_u"] = alpha if alpha_u is None else alpha_u
    rec["alpha_v"] = alpha if alpha_v is None else alpha_v
    rec["dist"] = _DISTS.get(distribution, DIST_BECKMANN)


def diffuse_record(reflectance=0.5, rough: bool = False,
                   alpha: float = 0.2) -> dict:
    """``diffuse`` / ``roughdiffuse`` (Oren-Nayar of roughness alpha)."""
    rec = default_record()
    rec["type"] = ROUGHDIFFUSE if rough else DIFFUSE
    rec["refl"] = _rgb(reflectance)
    if rough:
        rec["alpha_u"] = rec["alpha_v"] = alpha
    return rec


def dielectric_record(int_ior="bk7", ext_ior="air", specular=1.0,
                      transmittance=1.0, kind: int = DIELECTRIC,
                      alpha: float = 0.1, alpha_u: float | None = None,
                      alpha_v: float | None = None,
                      distribution: str = "beckmann") -> dict:
    """``dielectric``, ``thindielectric`` or ``roughdielectric`` (``kind``,
    the type code): relative IOR int/ext, specular reflectance and
    transmittance, and the rough kind's microfacet roughness."""
    rec = default_record()
    rec["type"] = kind
    rec["eta_s"] = _eta(int_ior, ext_ior)
    rec["spec"] = _rgb(specular)
    rec["trans"] = _rgb(transmittance)
    if kind == ROUGHDIELECTRIC:
        _set_alpha(rec, alpha, alpha_u, alpha_v, distribution)
    return rec


def plastic_record(int_ior="bk7", ext_ior="air", diffuse=0.5,
                   specular=1.0, rough: bool = False, alpha: float = 0.1,
                   alpha_u: float | None = None, alpha_v: float | None = None,
                   distribution: str = "beckmann") -> dict:
    """``plastic`` / ``roughplastic``: IORs by name or number, diffuse and
    specular reflectance, and the rough kind's microfacet roughness."""
    rec = default_record()
    rec["type"] = ROUGHPLASTIC if rough else PLASTIC
    rec["eta_s"] = _eta(int_ior, ext_ior)
    rec["refl"] = _rgb(diffuse)
    rec["spec"] = _rgb(specular)
    if rough:
        _set_alpha(rec, alpha, alpha_u, alpha_v, distribution)
    return rec


def coating_record(substrate: dict | None = None, int_ior="bk7",
                   ext_ior="air", thickness: float = 1.0, sigma_a=0.0,
                   specular=1.0) -> dict:
    """``coating`` flattened into one row over a diffuse-class substrate:
    the substrate's reflectance, sigma_a * thickness in ``trans``.  Other
    substrates are not ported (the reference substitutes plastic)."""
    base = substrate if substrate is not None else default_record()
    if int(base["type"]) not in (DIFFUSE, ROUGHDIFFUSE):
        raise NotImplementedError(
            "coating over a non-diffuse substrate is not ported")
    rec = default_record()
    rec["type"] = COATING
    rec["eta_s"] = _eta(int_ior, ext_ior)
    rec["refl"] = np.asarray(base["refl"])
    rec["trans"] = _rgb(sigma_a) * thickness
    rec["spec"] = _rgb(specular)
    return rec


def phong_record(exponent: float = 30.0, diffuse=0.5,
                 specular=0.2) -> dict:
    rec = default_record()
    rec["type"] = PHONG
    rec["exponent"] = exponent
    rec["refl"] = _rgb(diffuse)
    rec["spec"] = _rgb(specular)
    return rec


def ward_record(alpha: float = 0.1, alpha_u: float | None = None,
                alpha_v: float | None = None, diffuse=0.5,
                specular=0.2) -> dict:
    """``ward``, the balanced variant (the distribution column is unused)."""
    rec = default_record()
    rec["type"] = WARD
    rec["alpha_u"] = alpha if alpha_u is None else alpha_u
    rec["alpha_v"] = alpha if alpha_v is None else alpha_v
    rec["refl"] = _rgb(diffuse)
    rec["spec"] = _rgb(specular)
    return rec


def null_record() -> dict:
    rec = default_record()
    rec["type"] = NULL_BSDF
    return rec


def difftrans_record(transmittance=0.5) -> dict:
    rec = default_record()
    rec["type"] = DIFFTRANS
    rec["trans"] = _rgb(transmittance)
    return rec


def twosided(rec: dict) -> dict:
    """The ``twosided`` wrapper: the nested record with the twosided flag."""
    out = dict(rec)
    out["flags"] = int(out.get("flags", 0)) | FLAG_TWOSIDED
    return out


def hk_record(sigma_s=None, sigma_a=None, sigma_t=None, albedo=0.8,
              thickness: float = 1.0, g: float = 0.0) -> dict:
    """``hk`` (Hanrahan-Krueger): single-scattering albedo in ``refl``,
    optical depth tau in ``trans``, the HG asymmetry g in ``alpha_u`` and
    ``alpha_v``.  Give sigma_s and/or sigma_a (defaults 2 and 0.05), or
    sigma_t with an albedo."""
    if sigma_s is not None or sigma_a is not None:
        s = _rgb(2.0 if sigma_s is None else sigma_s)
        a = _rgb(0.05 if sigma_a is None else sigma_a)
    elif sigma_t is not None:
        st, al = _rgb(sigma_t), _rgb(albedo)
        s, a = st * al, st * (1 - al)
    else:
        s, a = np.full(3, 2.0), np.full(3, 0.05)
    st = np.maximum(s + a, 1e-8)
    rec = default_record()
    rec["type"] = HK
    rec["refl"] = s / st
    rec["trans"] = st * thickness
    rec["alpha_u"] = rec["alpha_v"] = float(g)
    return rec


def table_from_arrays(arrays: dict, used_types, unwrap_depth: int,
                      has_bump: bool, device) -> BSDFTable:
    """A BSDFTable from numpy columns (from ``scene/build.py`` or the bridge);
    ``arrays`` also carries the TEXTURE_COLUMNS."""
    cols = {k: host_tensor(arrays[k], np.int32 if k in _INT_LEAVES
                           else np.float32, device) for k in BSDF_LEAVES}
    textured = any(bool((np.asarray(arrays[k]) != INVALID).any())
                   for k in TEXTURE_COLUMNS)
    return BSDFTable(**cols, used_types=tuple(used_types),
                     unwrap_depth=int(unwrap_depth), has_bump=bool(has_bump),
                     textured=textured)


def build_table(records: list[dict], device) -> BSDFTable:
    recs = records or [default_record()]
    types = {int(r["type"]) for r in recs}
    if BLEND in types:
        depth = 4
    elif MASK in types:
        depth = 1
    else:
        depth = 0
    arrays = {k: np.stack([np.asarray(r[k]) for r in recs])
              for k in BSDF_LEAVES + TEXTURE_COLUMNS}
    return table_from_arrays(
        arrays, sorted(types), depth,
        any(int(r.get("bump_kind", BUMP_NONE)) != BUMP_NONE for r in recs),
        device)


@dataclasses.dataclass(frozen=True)
class LaneParams3:
    """Per-lane BSDF parameters of the ported types: spectra are V3,
    scalars flat (N,)."""

    type: torch.Tensor
    dist: torch.Tensor
    refl: V3
    spec: V3
    trans: V3
    eta: V3
    k: V3
    eta_s: torch.Tensor
    alpha_u: torch.Tensor
    alpha_v: torch.Tensor
    exponent: torch.Tensor
    flags: torch.Tensor
    used_types: tuple = (DIFFUSE,)


def resolve_v(table: BSDFTable, bsdf_id: torch.Tensor) -> LaneParams3:
    """Gather each lane's parameter row (no texture or wrapper support, so
    the reference's mask opacity is 1 and its uv lookups drop out).
    Roughness is clamped to at least 1e-4, as the reference does, except
    HK's g (see the module note, C7)."""
    if table.textured or table.unwrap_depth > 0:
        raise NotImplementedError(
            "textured BSDF parameters and MASK/BLEND wrappers are not "
            "ported yet")
    bid = torch.where(bsdf_id == INVALID, 0, bsdf_id)
    row = lambda col: v.gather_row(col, bid)  # noqa: E731

    def read(name):
        """The column's rows if a used type reads it, else a view of its
        row 0 (never read)."""
        col = getattr(table, name)
        if any(t in table.used_types for t in _READERS[name]):
            return row(col)
        return col[0].expand(bid.shape + col.shape[1:])

    typ = row(table.type)
    au, av = row(table.alpha_u), row(table.alpha_v)
    if HK in table.used_types:
        hk = typ == HK
        au = torch.where(hk, au, torch.clamp_min(au, 1e-4))
        av = torch.where(hk, av, torch.clamp_min(av, 1e-4))
    else:
        au, av = torch.clamp_min(au, 1e-4), torch.clamp_min(av, 1e-4)
    return LaneParams3(
        type=typ, dist=row(table.dist),
        refl=v.gather_v3(table.refl, bid), spec=v.gather_v3(table.spec, bid),
        trans=V3.from_array(read("trans")),
        eta=v.gather_v3(table.eta, bid), k=v.gather_v3(table.k, bid),
        eta_s=read("eta_s"), alpha_u=au, alpha_v=av,
        exponent=read("exponent"), flags=row(table.flags),
        used_types=table.used_types)
