"""Texture table and per-lane evaluation
(``mitsuba_im_tpu/texture/texture.py``): constant, bitmap (one flat atlas
with a MIP pyramid per bitmap), checker, grid and scale.

Every bitmap is packed with its box-filtered MIP pyramid into one flat
``(P, 3)`` atlas (level offsets in ``mip_offset``).  A lookup is a bilinear
4-texel gather at the base level, or, with screen-space UV derivatives
``duv`` (ray differentials, ``render/raydiff.py``), the reference's
trilinear filter with ``ANISO_TAPS`` fixed Gaussian-weighted taps along the
footprint's major axis (its stand-in for the EWA filter of ``mipmap.h``).
Dispatch is by type code over the types present (static ``used_types``);
a caller narrows them to the types its ids reach (:func:`reached_types`),
so that no lookup runs a branch, with its gathers and their backward
scatters, that none of its lanes takes.  A SCALE lane looks its nested
texture up in the same pass as the others.

The values are the reference's; the layout is not.  The reference resolves
the columns of small tables through select chains and gathers each texel
corner on its own; here every column is a row lookup (``v3.gather_row``)
and the texels of one lookup (4 corners, times 2 levels and
``ANISO_TAPS`` taps when filtered) are one gather from the atlas, whose
backward is one ``index_put_``.  The float sums run in the reference's
order; XLA on the CPU fuses multiply-adds, so the two differ in the last
bits, and a coordinate within an ulp of a texel edge may land on the
neighbouring texel.

Under a gradient of the atlas, lanes whose uv is not finite (misses: the
padding disk's radius is 0) are looked up at uv 0, so that their zero
cotangents meet finite bilinear weights; the reference's reverse mode is
NaN there (ROADMAP C6's mechanism).  Their values are never read.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import INVALID, Int, Float, host_tensor
from ..core import v3 as v
from ..core.v3 import V3

TEX_CONST = 0
TEX_BITMAP = 1
TEX_CHECKER = 2
TEX_GRID = 3
TEX_SCALE = 4  # value0 * nested
TEX_WIREFRAME = 5
TEX_VERTEXCOLORS = 6
TEX_CURVATURE = 7

WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2

MAX_MIP = 16     # level offsets per record (up to 32768^2 textures)
ANISO_TAPS = 4   # fixed trilinear probes along the footprint's major axis


@dataclasses.dataclass(frozen=True)
class TextureTable:
    type: torch.Tensor  # (X,) int32
    value0: torch.Tensor  # (X, 3) const color / checker c0 / scale factor
    value1: torch.Tensor  # (X, 3) checker c1 / grid line color
    offset: torch.Tensor  # (X,) int32 atlas start (bitmap)
    width: torch.Tensor  # (X,) int32
    height: torch.Tensor  # (X,) int32
    uvscale: torch.Tensor  # (X, 2)
    uvoffset: torch.Tensor  # (X, 2)
    param0: torch.Tensor  # (X,) grid line width
    wrap: torch.Tensor  # (X,) int32
    nested: torch.Tensor  # (X,) int32 (scale)
    gamma_srgb: torch.Tensor  # (X,) int32
    atlas: torch.Tensor  # (P, 3) every bitmap texel, levels appended
    mip_offset: torch.Tensor  # (X, MAX_MIP) int32 atlas start of each level
    n_levels: torch.Tensor  # (X,) int32 pyramid depth (1 = base only)
    used_types: tuple = (TEX_CONST,)
    has_mip: bool = False


TEXTURE_LEAVES = tuple(f.name for f in dataclasses.fields(TextureTable)
                       if f.name not in ("used_types", "has_mip"))
_INT_LEAVES = ("type", "offset", "width", "height", "wrap", "nested",
               "gamma_srgb", "mip_offset", "n_levels")


def _default_record() -> dict:
    return dict(
        type=TEX_CONST, value0=np.zeros(3), value1=np.zeros(3),
        offset=0, width=0, height=0,
        uvscale=np.ones(2), uvoffset=np.zeros(2),
        param0=0.0, wrap=WRAP_REPEAT, nested=INVALID, gamma_srgb=0,
        mip_offset=np.zeros(MAX_MIP, np.int64), n_levels=1,
    )


class TextureBuilder:
    """Host-side accumulator of texture records and atlas texels (the
    reference's, numpy arithmetic and all, so its atlas is bit for bit the
    JAX package's)."""

    def __init__(self):
        self.records: list[dict] = []
        self.atlas_parts: list[np.ndarray] = []
        self.atlas_size = 0

    def add(self, **kw) -> int:
        rec = _default_record()
        rec.update(kw)
        self.records.append(rec)
        return len(self.records) - 1

    def add_constant(self, rgb) -> int:
        return self.add(type=TEX_CONST, value0=np.asarray(rgb, np.float64))

    def append_texels(self, flat: np.ndarray) -> int:
        """Append (K, 3) texels to the atlas; returns their offset."""
        off = self.atlas_size
        self.atlas_parts.append(flat)
        self.atlas_size += len(flat)
        return off

    def add_bitmap(self, pixels: np.ndarray, uvscale=(1, 1), uvoffset=(0, 0),
                   wrap=WRAP_REPEAT) -> int:
        """pixels: (H, W, 3) linear RGB.  Appends the base level and its MIP
        pyramid (2x2 box, each odd side padded by repeating its edge)."""
        h, w = pixels.shape[:2]
        img = np.asarray(pixels, np.float32)
        mip_off = np.zeros(MAX_MIP, np.int64)
        n_levels = 0
        off = self.atlas_size
        while True:
            mip_off[n_levels] = self.append_texels(img.reshape(-1, 3))
            n_levels += 1
            lh, lw = img.shape[:2]
            if (lh <= 1 and lw <= 1) or n_levels >= MAX_MIP:
                break
            ph, pw = lh + (lh & 1), lw + (lw & 1)
            pad = np.pad(img, ((0, ph - lh), (0, pw - lw), (0, 0)),
                         mode="edge")
            img = 0.25 * (pad[0::2, 0::2] + pad[1::2, 0::2]
                          + pad[0::2, 1::2] + pad[1::2, 1::2])
        mip_off[n_levels:] = mip_off[n_levels - 1]
        return self.add(
            type=TEX_BITMAP, offset=off, width=w, height=h,
            uvscale=np.asarray(uvscale, np.float64),
            uvoffset=np.asarray(uvoffset, np.float64), wrap=wrap,
            mip_offset=mip_off, n_levels=n_levels,
        )

    def type_arrays(self) -> dict:
        """The ``type`` and ``nested`` columns as numpy (for
        :func:`reached_types`)."""
        recs = self.records or [_default_record()]
        return {k: np.array([int(r[k]) for r in recs], np.int64)
                for k in ("type", "nested")}

    def build(self, device) -> TextureTable:
        recs = self.records or [_default_record()]
        arrays = {k: np.stack([np.asarray(r[k]) for r in recs])
                  for k in TEXTURE_LEAVES if k != "atlas"}
        arrays["atlas"] = (np.concatenate(self.atlas_parts, axis=0)
                           if self.atlas_parts
                           else np.zeros((1, 3), np.float32))
        return table_from_arrays(
            arrays, sorted({int(r["type"]) for r in recs}),
            any(int(r["n_levels"]) > 1 for r in recs), device)


def table_from_arrays(arrays: dict, used_types, has_mip: bool,
                      device) -> TextureTable:
    """A TextureTable from numpy leaves (the builder's or the bridge's);
    ``mip_offset`` is int64 on the host and int32 on the device."""
    cols = {k: host_tensor(arrays[k], np.int32 if k in _INT_LEAVES
                           else np.float32, device) for k in TEXTURE_LEAVES}
    return TextureTable(**cols, used_types=tuple(used_types),
                        has_mip=bool(has_mip))


def reached_types(types: np.ndarray, nested: np.ndarray,
                  ids: np.ndarray) -> tuple:
    """The texture types that a lookup of the texture ids ``ids`` evaluates
    (host arrays): the ids' own, and for a SCALE its nested texture's
    (INVALID meaning texture 0; a nested SCALE evaluates to 0, as the
    reference recurses once).  INVALID ids reach nothing: their lanes take
    the caller's constant or are not read."""
    types, nested = np.asarray(types), np.asarray(nested)
    ids = np.unique(np.asarray(ids))
    ids = ids[ids != INVALID]
    own = set(types[ids].tolist())
    if TEX_SCALE in own:
        inner = nested[ids[types[ids] == TEX_SCALE]]
        inner = np.where(inner == INVALID, 0, inner)
        own |= set(types[inner].tolist()) - {TEX_SCALE}
    return tuple(sorted(own))


def _wrap_coord(x, n, wrap_mode):
    """Integer texel coordinate wrapping per lane (repeat, clamp, mirror);
    ``torch.remainder`` rounds toward -inf as ``jnp.mod`` does."""
    n = torch.clamp_min(n, 1)
    rep = torch.remainder(x, n)
    clmp = torch.minimum(torch.clamp_min(x, 0), n - 1)
    period = 2 * n
    mx = torch.remainder(x, period)
    mir = torch.where(mx >= n, period - 1 - mx, mx)
    return torch.where(wrap_mode == WRAP_REPEAT, rep,
                       torch.where(wrap_mode == WRAP_CLAMP, clmp, mir))


def _bilinear_taps(n_texels, offl, wl, hl, wrap, us, vs):
    """The four atlas indices of a bilinear lookup at one (per-lane) level,
    (4, N) int64 in the order (x0,y0), (x1,y0), (x0,y1), (x1,y1), and
    their fractions (dx, dy)."""
    fx = us * wl.to(Float) - 0.5
    fy = vs * hl.to(Float) - 0.5
    x0 = torch.floor(fx).to(Int)
    y0 = torch.floor(fy).to(Int)
    dx = fx - x0.to(Float)
    dy = fy - y0.to(Float)
    xa, xb = _wrap_coord(x0, wl, wrap), _wrap_coord(x0 + 1, wl, wrap)
    row = torch.clamp_min(wl, 1)
    ya = offl + _wrap_coord(y0, hl, wrap) * row
    yb = offl + _wrap_coord(y0 + 1, hl, wrap) * row
    idx = torch.stack([ya + xa, ya + xb, yb + xa, yb + xb])
    return torch.clamp(idx, 0, n_texels - 1).to(torch.int64), dx, dy


def _bilinear(t: torch.Tensor, dx, dy) -> V3:
    """Blend gathered texels ``t`` (4, N, 3) in the reference's order."""
    c = [V3.from_array(t[k]) for k in range(4)]
    return (c[0] * ((1 - dx) * (1 - dy)) + c[1] * (dx * (1 - dy))
            + c[2] * ((1 - dx) * dy) + c[3] * (dx * dy))


def _level_dims(w, h, lvl):
    """ceil(w / 2^lvl), the builder's iterated ceil-halving."""
    sh = torch.bitwise_left_shift(torch.ones_like(lvl), lvl)
    wl = torch.clamp_min(torch.bitwise_right_shift(w + sh - 1, lvl), 1)
    hl = torch.clamp_min(torch.bitwise_right_shift(h + sh - 1, lvl), 1)
    return wl, hl


def _filtered_bitmap_v(table, tid, w, h, wrap, us, vs, su, sv, duv):
    """Trilinear lookup with ANISO_TAPS fixed taps along the footprint's
    major axis; the 2 x ANISO_TAPS x 4 texels are one gather."""
    dudx, dvdx, dudy, dvdy = duv
    wf = torch.clamp_min(w, 1).to(Float)
    hf = torch.clamp_min(h, 1).to(Float)
    # footprint axes in texel space
    ax_u = dudx * su * wf
    ax_v = dvdx * sv * hf
    ay_u = dudy * su * wf
    ay_v = dvdy * sv * hf
    lx2 = ax_u * ax_u + ax_v * ax_v
    ly2 = ay_u * ay_u + ay_v * ay_v
    major2 = torch.maximum(lx2, ly2)
    minor2 = torch.minimum(lx2, ly2)
    # cap the anisotropy at the tap count (the taps cover the major axis)
    minor2 = torch.maximum(minor2, major2 / (ANISO_TAPS * ANISO_TAPS))
    lod = torch.clamp_min(0.5 * torch.log2(torch.clamp_min(minor2, 1.0)),
                          0.0)
    lmax = torch.clamp_min(v.gather_row(table.n_levels, tid) - 1, 0)
    l0 = torch.minimum(torch.floor(lod).to(Int), lmax)
    l1 = torch.minimum(l0 + 1, lmax)
    fr = torch.clamp(lod - l0.to(Float), 0.0, 1.0)

    mip_flat = table.mip_offset.reshape(-1)
    off0 = v.gather_row(mip_flat, tid * MAX_MIP + l0)
    off1 = v.gather_row(mip_flat, tid * MAX_MIP + l1)
    w0, h0 = _level_dims(w, h, l0)
    w1, h1 = _level_dims(w, h, l1)

    # major-axis direction in (scaled) uv space
    x_major = lx2 >= ly2
    mu = torch.where(x_major, dudx, dudy) * su
    mv = torch.where(x_major, dvdx, dvdy) * sv

    n_texels = table.atlas.shape[0]
    idx, fracs = [], []
    for i in range(ANISO_TAPS):
        t = (i + 0.5) / ANISO_TAPS - 0.5
        ui = us + mu * t
        vi = vs + mv * t
        for offl, wl, hl in ((off0, w0, h0), (off1, w1, h1)):
            k, dx, dy = _bilinear_taps(n_texels, offl, wl, hl, wrap, ui, vi)
            idx.append(k)
            fracs.append((dx, dy))
    texels = v.gather_row(table.atlas, torch.cat(idx)).reshape(
        len(idx), 4, *us.shape, 3)
    acc = v.zeros(us.shape, us.device)
    wsum = 0.0
    for i in range(ANISO_TAPS):
        wgt = float(np.exp(-2.0 * (2.0 * ((i + 0.5) / ANISO_TAPS - 0.5)) ** 2))
        c0 = _bilinear(texels[2 * i], *fracs[2 * i])
        c1 = _bilinear(texels[2 * i + 1], *fracs[2 * i + 1])
        acc = acc + (c0 + (c1 - c0) * fr) * wgt
        wsum += wgt
    return acc / wsum


def eval_texture_v(table: TextureTable, tex_id: torch.Tensor,
                   uv_u: torch.Tensor, uv_v: torch.Tensor,
                   const_rgb: V3 | None = None, duv=None) -> V3:
    """Texture values per lane (V3).  INVALID ids take ``const_rgb`` (or
    texture 0's value when it is None); ``duv`` (du/dx, dv/dx, du/dy, dv/dy)
    switches bitmaps to the MIP/anisotropic filter when the table has
    pyramids."""
    if table.atlas.requires_grad:
        # a miss lane's uv is not finite (the padding disk's radius is 0):
        # look it up at 0, so that its zero cotangent meets finite bilinear
        # weights (the reference's reverse mode turns it into NaN)
        ok = torch.isfinite(uv_u) & torch.isfinite(uv_v)
        uv_u = torch.where(ok, uv_u, 0.0)
        uv_v = torch.where(ok, uv_v, 0.0)
    tid = torch.where(tex_id == INVALID, 0, tex_id)
    ttype = v.gather_row(table.type, tid)
    scaled = TEX_SCALE in table.used_types
    if scaled:
        # a SCALE lane evaluates its nested texture (INVALID: texture 0)
        # times its value0; a nested SCALE matches no branch below and is
        # 0, as the reference's single recursion gives
        is_scale = ttype == TEX_SCALE
        factor = v.gather_v3(table.value0, tid)
        nested = v.gather_row(table.nested, tid)
        tid = torch.where(is_scale, torch.where(nested == INVALID, 0, nested),
                          tid)
        ttype = torch.where(is_scale, v.gather_row(table.type, tid), ttype)
    gc = lambda col: v.gather_row(col, tid)  # noqa: E731
    out = v.zeros(uv_u.shape, uv_u.device)
    uvs, uvo = gc(table.uvscale), gc(table.uvoffset)
    su, sv = uvs[..., 0], uvs[..., 1]
    us = uv_u * su + uvo[..., 0]
    vs = uv_v * sv + uvo[..., 1]

    if TEX_CONST in table.used_types:
        out = v.where(ttype == TEX_CONST, v.gather_v3(table.value0, tid), out)

    if TEX_BITMAP in table.used_types:
        w, h = gc(table.width), gc(table.height)
        wrap = gc(table.wrap)
        if duv is not None and table.has_mip:
            c = _filtered_bitmap_v(table, tid, w, h, wrap, us, vs, su, sv,
                                   duv)
        else:
            wl, hl = torch.clamp_min(w, 1), torch.clamp_min(h, 1)
            k, dx, dy = _bilinear_taps(table.atlas.shape[0], gc(table.offset),
                                       wl, hl, wrap, us, vs)
            c = _bilinear(v.gather_row(table.atlas, k), dx, dy)
        out = v.where(ttype == TEX_BITMAP, c, out)

    if TEX_CHECKER in table.used_types:
        xi = torch.floor(us * 2.0).to(Int)
        yi = torch.floor(vs * 2.0).to(Int)
        even = torch.remainder(xi + yi, 2) == 0
        c = v.where(even, v.gather_v3(table.value0, tid),
                    v.gather_v3(table.value1, tid))
        out = v.where(ttype == TEX_CHECKER, c, out)

    if TEX_GRID in table.used_types:
        lw = gc(table.param0)
        fx = us - torch.floor(us)
        fy = vs - torch.floor(vs)
        on_line = (fx < lw) | (fx > 1 - lw) | (fy < lw) | (fy > 1 - lw)
        c = v.where(on_line, v.gather_v3(table.value1, tid),
                    v.gather_v3(table.value0, tid))
        out = v.where(ttype == TEX_GRID, c, out)

    if scaled:
        out = v.where(is_scale, out * factor, out)

    if const_rgb is not None:
        out = v.where(tex_id == INVALID, const_rgb, out)
    return out
