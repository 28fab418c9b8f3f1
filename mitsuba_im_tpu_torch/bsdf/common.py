"""BSDF parameter tables and per-lane resolution
(``mitsuba_im_tpu/bsdf/common.py``), and the record factories of the
ported types and wrappers (``mitsuba_im_tpu/bsdf/__init__.py``, taking
keyword arguments where the reference reads a ``Properties`` bag).

Each scene BSDF is one row of typed parameters; lanes gather their row into
a :class:`LaneParams3` through the one row lookup ``v3.gather_row``,
unwrapping MASK and BLEND rows and looking up the textures that a row
references (``texture/texture.py``).  Bump and normal maps tilt the
shading frame in ``scene/scene.py``.  IRAWAN rows carry their weave
pattern (``bsdf/irawan.py``) as static data: the table keeps the distinct
patterns in ``weaves`` and each row's index into them in ``weave_id``, and
the lane parameters carry the lanes' uvs, which the cloth model reads.

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
from ..core import rng as mrng
from ..core import v3 as v
from ..core.v3 import V3
from ..texture.texture import TextureTable, eval_texture_v, reached_types
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

# frame perturbation kinds (the bumpmap / normalmap wrappers)
BUMP_NONE = 0
BUMP_HEIGHT = 1
BUMP_NORMAL = 2
FLAG_TWOSIDED = 1

_DISTS = {"beckmann": DIST_BECKMANN, "ggx": DIST_GGX, "phong": DIST_PHONG,
          "as": DIST_BECKMANN}

TEXTURE_COLUMNS = ("refl_tex", "spec_tex", "trans_tex", "alpha_tex",
                   "opacity_tex", "weight_tex", "bump_tex")


@dataclasses.dataclass(frozen=True)
class BSDFTable:
    type: torch.Tensor  # (B,) int32
    dist: torch.Tensor  # (B,) int32 microfacet distribution
    refl: torch.Tensor  # (B, 3) diffuse reflectance (HK: albedo)
    refl_tex: torch.Tensor  # (B,) int32 texture id or INVALID
    spec: torch.Tensor  # (B, 3) specular reflectance
    spec_tex: torch.Tensor
    trans: torch.Tensor  # (B, 3) transmittance (coating: sigma_a d, HK: tau)
    trans_tex: torch.Tensor
    eta: torch.Tensor  # (B, 3) conductor ior (rgb)
    k: torch.Tensor  # (B, 3) conductor absorption
    eta_s: torch.Tensor  # (B,) dielectric relative ior (int / ext)
    alpha_u: torch.Tensor  # (B,) roughness (HK: the HG asymmetry g)
    alpha_v: torch.Tensor  # (B,)
    alpha_tex: torch.Tensor  # (B,) int32
    exponent: torch.Tensor  # (B,) phong exponent
    opacity: torch.Tensor  # (B, 3) mask opacity
    opacity_tex: torch.Tensor
    flags: torch.Tensor  # (B,) int32 (twosided)
    nested: torch.Tensor  # (B,) int32 nested bsdf id (mask, blend)
    nested2: torch.Tensor  # (B,) int32 second nested bsdf (blend)
    weight: torch.Tensor  # (B,) blend weight toward nested2
    weight_tex: torch.Tensor  # (B,) int32
    bump_tex: torch.Tensor  # (B,) int32 height / normal texture
    bump_kind: torch.Tensor  # (B,) int32 BUMP_*
    bump_scale: torch.Tensor  # (B,)
    used_types: tuple = (DIFFUSE,)
    unwrap_depth: int = 0  # MASK/BLEND nesting budget
    # host-side statics: the texture columns some row references, the bump
    # kinds some row uses (a lookup nothing references is skipped), and,
    # where the builder knew the texture table, ((column, texture types its
    # ids reach), ...) (see column_textures)
    tex_columns: tuple = ()
    bump_kinds: tuple = ()
    tex_types: tuple = ()
    # IRAWAN: the distinct weave patterns and each row's index into them
    weave_id: torch.Tensor | None = None  # (B,) int32
    weaves: tuple = ()

    @property
    def has_bump(self) -> bool:
        return bool(self.bump_kinds)


BSDF_LEAVES = tuple(f.name for f in dataclasses.fields(BSDFTable)
                    if f.type == "torch.Tensor")
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
_INT_LEAVES = ("type", "dist", "flags", "nested", "nested2",
               "bump_kind") + TEXTURE_COLUMNS


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


def mask_record(nested: int, opacity=0.5, opacity_tex: int = INVALID) -> dict:
    """``mask`` over the BSDF row ``nested`` (a builder's id): opacity as
    an rgb value or a texture id."""
    rec = default_record()
    rec["type"] = MASK
    rec["opacity"] = _rgb(opacity)
    rec["opacity_tex"] = int(opacity_tex)
    rec["nested"] = int(nested)
    return rec


def blend_record(nested: int, nested2: int, weight: float = 0.5,
                 weight_tex: int = INVALID) -> dict:
    """``blendbsdf`` of the rows ``nested`` and ``nested2``: each shading
    point takes ``nested2`` with probability ``weight`` (clipped to [0, 1])
    or the mean of the texture ``weight_tex``."""
    rec = default_record()
    rec["type"] = BLEND
    rec["weight"] = float(np.clip(weight, 0.0, 1.0))
    rec["weight_tex"] = int(weight_tex)
    rec["nested"] = int(nested)
    rec["nested2"] = int(nested2)
    return rec


def bump(rec: dict, tex: int, kind: int = BUMP_HEIGHT,
         scale: float = 1.0) -> dict:
    """The ``bumpmap`` (``kind=BUMP_HEIGHT``) or ``normalmap``
    (``BUMP_NORMAL``) wrapper: the record with the texture ``tex`` tilting
    its shading frame."""
    out = dict(rec)
    out.update(bump_tex=int(tex), bump_kind=int(kind),
               bump_scale=float(scale))
    return out


def table_from_arrays(arrays: dict, used_types, unwrap_depth: int,
                      device, tex_arrays: dict | None = None,
                      weaves: tuple = ()) -> BSDFTable:
    """A BSDFTable from numpy columns (from ``scene/build.py`` or the
    bridge); ``tex_arrays`` (the texture table's ``type`` and ``nested``
    columns) gives each textured column the texture types it reaches;
    ``weaves`` are the IRAWAN patterns that ``arrays["weave_id"]`` (zeros
    when absent) indexes."""
    cols = {k: host_tensor(arrays[k], np.int32 if k in _INT_LEAVES
                           else np.float32, device) for k in BSDF_LEAVES}
    tex_columns = tuple(k for k in TEXTURE_COLUMNS
                        if (np.asarray(arrays[k]) != INVALID).any())
    tex_types = () if tex_arrays is None else tuple(
        (k, reached_types(tex_arrays["type"], tex_arrays["nested"],
                          arrays[k])) for k in tex_columns)
    kinds = np.unique(np.asarray(arrays["bump_kind"]))
    weave_id = arrays.get("weave_id")
    if weave_id is None:
        weave_id = np.zeros(len(np.asarray(arrays["type"])), np.int32)
    return BSDFTable(**cols, used_types=tuple(used_types),
                     unwrap_depth=int(unwrap_depth), tex_columns=tex_columns,
                     bump_kinds=tuple(int(k) for k in kinds if k != BUMP_NONE),
                     tex_types=tex_types,
                     weave_id=host_tensor(weave_id, np.int32, device),
                     weaves=tuple(weaves))


def column_textures(table: BSDFTable, tex: TextureTable,
                    column: str) -> TextureTable:
    """``tex`` as the column ``column`` looks it up: its ``used_types``
    narrowed to the types the column's ids reach (``tex_types``; the whole
    set where the table does not know them).  Forward values are the same:
    a branch no lane of the column takes is skipped, with its gathers and
    their backward scatters into the atlas."""
    types = dict(table.tex_types).get(column)
    return tex if types is None else dataclasses.replace(tex,
                                                         used_types=types)


def build_table(records: list[dict], device,
                tex_arrays: dict | None = None) -> BSDFTable:
    recs = records or [default_record()]
    types = {int(r["type"]) for r in recs}
    # the static unwrap budget: BLEND chains may stack a few levels deep,
    # possibly over MASK wrappers
    if BLEND in types:
        depth = 4
    elif MASK in types:
        depth = 1
    else:
        depth = 0
    arrays = {k: np.stack([np.asarray(r[k]) for r in recs])
              for k in BSDF_LEAVES}
    # IRAWAN: distinct weave patterns in first-use order, a row's index
    weaves, weave_ids = [], []
    for r in recs:
        wv = r.get("weave")
        if wv is not None and wv not in weaves:
            weaves.append(wv)
        weave_ids.append(0 if wv is None else weaves.index(wv))
    arrays["weave_id"] = np.asarray(weave_ids, np.int32)
    return table_from_arrays(arrays, sorted(types), depth, device,
                             tex_arrays, tuple(weaves))


@dataclasses.dataclass(frozen=True)
class LaneParams3:
    """Per-lane BSDF parameters, textures and wrappers resolved: spectra
    are V3, scalars flat (N,).  ``opacity`` is the MASK wrappers' product
    (None, meaning 1, where no row is a MASK)."""

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
    opacity: torch.Tensor | None = None
    used_types: tuple = (DIFFUSE,)
    # IRAWAN: the lanes' uvs and weave indices, and the table's patterns
    uv_u: torch.Tensor | None = None
    uv_v: torch.Tensor | None = None
    weave_id: torch.Tensor | None = None
    weaves: tuple = ()


def resolve_v(table: BSDFTable, tex: TextureTable | None,
              bsdf_id: torch.Tensor, uv_u: torch.Tensor | None = None,
              uv_v: torch.Tensor | None = None,
              u_sel: torch.Tensor | None = None, duv=None) -> LaneParams3:
    """Each lane's parameter row, MASK/BLEND wrappers unwrapped and texture
    references looked up at (uv_u, uv_v) (``tex`` and the uvs may be None
    for a table that references no texture and has no wrapper).

    The unwrap runs ``unwrap_depth`` rounds: a MASK multiplies the lane's
    opacity by the mean of its (textured) opacity and steps into its nested
    row; a BLEND picks ``nested2`` with probability w (the mean of its
    weight, textured or not) using ``u_sel`` (or a hash of the uv bits when
    None) and rescales that uniform for the next round, clipped to
    0.999999.  ``alpha_tex`` replaces both roughnesses by its texture's
    mean; ``refl``, ``spec`` and ``trans`` take their textures, filtered
    with ``duv`` when given.  A column that no row textures, or that no
    used type reads (``_READERS``), is not looked up.  Roughness is clamped
    to at least 1e-4, as the reference does, except HK's g (see the module
    note, C7)."""
    bid = torch.where(bsdf_id == INVALID, 0, bsdf_id)
    cols = table.tex_columns
    opacity = None
    if table.unwrap_depth > 0:
        u = _hash_uniform(uv_u, uv_v) if u_sel is None else u_sel
        for _ in range(table.unwrap_depth):
            # every wrapper column read at the round's entry row
            wtype = v.gather_row(table.type, bid)
            nested = v.gather_row(table.nested, bid)
            if BLEND in table.used_types:
                nested2 = v.gather_row(table.nested2, bid)
                weight = v.gather_row(table.weight, bid)
                weight_tex = (v.gather_row(table.weight_tex, bid)
                              if "weight_tex" in cols else None)
            if MASK in table.used_types:
                is_mask = wtype == MASK
                op_rgb = v.gather_v3(table.opacity, bid)
                if "opacity_tex" in cols:
                    op_rgb = eval_texture_v(
                        column_textures(table, tex, "opacity_tex"),
                        v.gather_row(table.opacity_tex, bid), uv_u,
                        uv_v, op_rgb)
                op = torch.where(is_mask,
                                 torch.clamp(op_rgb.mean(), 0.0, 1.0), 1.0)
                opacity = op if opacity is None else opacity * op
                bid = torch.where(is_mask & (nested != INVALID), nested, bid)
            if BLEND in table.used_types:
                is_blend = wtype == BLEND
                if weight_tex is not None:
                    wgt = eval_texture_v(
                        column_textures(table, tex, "weight_tex"), weight_tex,
                        uv_u, uv_v, V3(weight, weight, weight)).mean()
                else:
                    wgt = V3(weight, weight, weight).mean()
                wgt = torch.clamp(wgt, 0.0, 1.0)
                pick2 = u < wgt
                bid = torch.where(
                    is_blend, torch.where(pick2, nested2, nested), bid)
                u_re = torch.where(pick2, u / torch.clamp_min(wgt, 1e-8),
                                   (u - wgt) / torch.clamp_min(1.0 - wgt,
                                                               1e-8))
                u = torch.where(is_blend, torch.clamp(u_re, 0.0, 0.999999),
                                u)
            bid = torch.where(bid == INVALID, 0, bid)

    row = lambda col: v.gather_row(col, bid)  # noqa: E731

    def spectrum(name, reader=True):
        """The column's rows, through its texture if a row textures it; a
        view of row 0 (never read) if no used type reads it."""
        col = getattr(table, name)
        if not reader:
            return V3.from_array(col[0].expand(bid.shape + col.shape[1:]))
        val = v.gather_v3(col, bid)
        if name + "_tex" in cols:
            val = eval_texture_v(
                column_textures(table, tex, name + "_tex"),
                row(getattr(table, name + "_tex")), uv_u, uv_v, val, duv)
        return val

    def read(name):
        col = getattr(table, name)
        if any(t in table.used_types for t in _READERS[name]):
            return row(col)
        return col[0].expand(bid.shape + col.shape[1:])

    typ = row(table.type)
    au, av = row(table.alpha_u), row(table.alpha_v)
    if "alpha_tex" in cols:
        atex = row(table.alpha_tex)
        a_tex = eval_texture_v(column_textures(table, tex, "alpha_tex"),
                               atex, uv_u, uv_v, None).mean()
        has = atex != INVALID
        au, av = torch.where(has, a_tex, au), torch.where(has, a_tex, av)
    if HK in table.used_types:
        hk = typ == HK
        au = torch.where(hk, au, torch.clamp_min(au, 1e-4))
        av = torch.where(hk, av, torch.clamp_min(av, 1e-4))
    else:
        au, av = torch.clamp_min(au, 1e-4), torch.clamp_min(av, 1e-4)
    reads_trans = any(t in table.used_types for t in _READERS["trans"])
    return LaneParams3(
        type=typ, dist=row(table.dist),
        refl=spectrum("refl"), spec=spectrum("spec"),
        trans=spectrum("trans", reads_trans),
        eta=v.gather_v3(table.eta, bid), k=v.gather_v3(table.k, bid),
        eta_s=read("eta_s"), alpha_u=au, alpha_v=av,
        exponent=read("exponent"), flags=row(table.flags), opacity=opacity,
        used_types=table.used_types,
        **(dict(uv_u=uv_u, uv_v=uv_v, weave_id=row(table.weave_id),
                weaves=table.weaves) if table.weaves else {}))


def _hash_uniform(uv_u: torch.Tensor, uv_v: torch.Tensor) -> torch.Tensor:
    """A per-lane uniform from the bits of the lane's uv, for callers
    without a sampler (decorrelates shading points)."""
    bits = [t.to(torch.float32).contiguous().view(torch.int32)
            for t in (uv_u, uv_v)]
    return mrng.to_unit_float(mrng.hash_u32(*bits))
