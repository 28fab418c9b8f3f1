"""Texture record factories (``mitsuba_im_tpu/texture/__init__.py``): the
keyword factories, and the registered plugins that read a ``Properties``
bag and call them.

Each factory adds its record to a :class:`~.texture.TextureBuilder` (a
``SceneBuilder``'s ``textures``) and returns the texture id that a BSDF
record's ``*_tex`` column takes.  The keyword ``bitmap`` takes pixel
arrays; the ``bitmap`` plugin loads its ``filename`` through
``io/bitmap.py``, sRGB-decoding 8-bit formats unless ``gamma`` is 1, as the
reference does.  ``curvature`` is the reference's constant 0.5.
"""
from __future__ import annotations

import warnings

import numpy as np

from ..core.properties import Properties
from ..core.registry import register
from ..core.types import INVALID
from . import texture as tx

WRAP_MODES = {"repeat": tx.WRAP_REPEAT, "clamp": tx.WRAP_CLAMP,
              "mirror": tx.WRAP_MIRROR, "zero": tx.WRAP_CLAMP,
              "one": tx.WRAP_CLAMP}


def _rgb(value) -> np.ndarray:
    return np.broadcast_to(np.asarray(value, np.float64), (3,)).copy()


def _uv(uscale, vscale, uoffset, voffset):
    return dict(uvscale=np.array([uscale, vscale], np.float64),
                uvoffset=np.array([uoffset, voffset], np.float64))


def bitmap(tb: tx.TextureBuilder, pixels, uscale=1.0, vscale=1.0,
           uoffset=0.0, voffset=0.0, wrap: str = "repeat") -> int:
    """``bitmap`` from (H, W, 3+) linear RGB pixels, with its MIP pyramid;
    the wrap modes "zero" and "one" clamp, as in the reference."""
    uv = _uv(uscale, vscale, uoffset, voffset)
    return tb.add_bitmap(np.asarray(pixels)[..., :3], uvscale=uv["uvscale"],
                         uvoffset=uv["uvoffset"], wrap=WRAP_MODES[wrap])


def checkerboard(tb: tx.TextureBuilder, color0=0.4, color1=0.2, uscale=1.0,
                 vscale=1.0, uoffset=0.0, voffset=0.0) -> int:
    return tb.add(type=tx.TEX_CHECKER, value0=_rgb(color0),
                  value1=_rgb(color1), **_uv(uscale, vscale, uoffset, voffset))


def gridtexture(tb: tx.TextureBuilder, color0=0.2, color1=0.4,
                line_width=0.01, uscale=1.0, vscale=1.0, uoffset=0.0,
                voffset=0.0) -> int:
    """``gridtexture``: lines of ``color0`` on ``color1``."""
    return tb.add(type=tx.TEX_GRID, value0=_rgb(color1), value1=_rgb(color0),
                  param0=line_width, **_uv(uscale, vscale, uoffset, voffset))


def scale(tb: tx.TextureBuilder, nested: int = INVALID, scale=1.0,
          value=1.0) -> int:
    """``scale``: ``scale`` times the nested texture, or, without one, the
    constant ``value * scale``."""
    if nested >= 0:
        return tb.add(type=tx.TEX_SCALE, value0=_rgb(scale),
                      nested=int(nested))
    return tb.add_constant(_rgb(value) * _rgb(scale))


def wireframe(tb: tx.TextureBuilder, interior_color=0.5, edge_color=0.1,
              line_width=0.01) -> int:
    """``wireframe``, which needs each point's distance to its triangle's
    edges; the reference approximates it by a grid of ``edge_color`` lines
    over the uv square, and so does the port."""
    return tb.add(type=tx.TEX_GRID, value0=_rgb(interior_color),
                  value1=_rgb(edge_color), param0=line_width)


def vertexcolors(builder) -> int:
    """``vertexcolors``: a constant 0.5 placeholder that the next mesh the
    ``SceneBuilder`` ``builder`` takes bakes with its per-vertex colors
    (:func:`bake_vertex_colors`)."""
    tid = builder.textures.add_constant(np.full(3, 0.5))
    builder.pending_vertexcolors.append(tid)
    return tid


def curvature(tb: tx.TextureBuilder) -> int:
    """``curvature``: the reference stands a constant 0.5 in for the
    per-vertex curvature, and so does the port."""
    return tb.add_constant(np.full(3, 0.5))


def bake_vertex_colors(tb: tx.TextureBuilder, mesh, tex_ids):
    """Bake the mesh's corner colors into one 2x2-texel atlas block per
    triangle (the fourth texel c1 + c2 - c0 makes the bilinear lookup
    exactly barycentric) and turn the textures ``tex_ids`` into bitmaps of
    them; returns the (T, 3, 2) per-corner UVs that address the blocks, or
    None (with a warning, the textures keep 0.5) when the mesh has no
    colors."""
    idx = np.asarray(mesh.indices, np.int64)
    T = len(idx)
    if getattr(mesh, "colors", None) is None or T == 0:
        warnings.warn("vertexcolors: mesh has no per-vertex colors; using "
                      "the constant 0.5 fallback")
        return None
    col = np.asarray(mesh.colors, np.float32)
    c0, c1, c2 = col[idx[:, 0]], col[idx[:, 1]], col[idx[:, 2]]
    img = np.empty((2, 2 * T, 3), np.float32)
    img[0, 0::2] = c0
    img[0, 1::2] = c1
    img[1, 0::2] = c2
    img[1, 1::2] = c1 + c2 - c0  # kills the bilinear cross term
    off = tb.append_texels(img.reshape(-1, 3))
    for tid in tex_ids:
        tb.records[tid].update(
            type=tx.TEX_BITMAP, offset=off, width=2 * T, height=2,
            wrap=tx.WRAP_CLAMP, uvscale=np.ones(2), uvoffset=np.zeros(2),
            mip_offset=np.full(tx.MAX_MIP, off, np.int64), n_levels=1,
        )
    ii = np.arange(T, dtype=np.float64)
    u0 = (2 * ii + 0.5) / (2 * T)
    u1 = (2 * ii + 1.5) / (2 * T)
    uv = np.empty((T, 3, 2), np.float64)
    uv[:, 0, 0] = u0
    uv[:, 0, 1] = 0.25
    uv[:, 1, 0] = u1
    uv[:, 1, 1] = 0.25
    uv[:, 2, 0] = u0
    uv[:, 2, 1] = 0.75
    return uv


# -- the registered plugins ------------------------------------------------

def _uv_props(props: Properties) -> dict:
    return dict(uscale=props.get_float("uscale", 1.0),
                vscale=props.get_float("vscale", 1.0),
                uoffset=props.get_float("uoffset", 0.0),
                voffset=props.get_float("voffset", 0.0))


@register("texture", "bitmap")
def _bitmap(props: Properties, ctx=None):
    from ..io import bitmap as bmp

    path = props.get_string("filename")
    if ctx is not None:
        path = ctx.resolve_path(path)
    gamma = props.get_float("gamma", -1.0)
    pixels = bmp.load(path, gamma_correct=(gamma != 1.0))[..., :3]
    wrap = props.get_string("wrapMode", "repeat")
    props.get_string("filterType", "ewa")
    uv = _uv_props(props)
    if ctx is None:
        return INVALID
    return bitmap(ctx.textures, pixels, wrap=wrap, **uv)


@register("texture", "checkerboard")
def _checkerboard(props: Properties, ctx=None):
    c0 = props.get_spectrum("color0", np.full(3, 0.4))
    c1 = props.get_spectrum("color1", np.full(3, 0.2))
    uv = _uv_props(props)
    if ctx is None:
        return INVALID
    return checkerboard(ctx.textures, c0, c1, **uv)


@register("texture", "gridtexture")
def _gridtexture(props: Properties, ctx=None):
    c0 = props.get_spectrum("color0", np.full(3, 0.2))
    c1 = props.get_spectrum("color1", np.full(3, 0.4))
    lw = props.get_float("lineWidth", 0.01)
    uv = _uv_props(props)
    if ctx is None:
        return INVALID
    return gridtexture(ctx.textures, c0, c1, lw, **uv)


@register("texture", "scale")
def _scale(props: Properties, ctx=None):
    """``scale`` times the nested texture, or without one the constant
    ``value * scale``.  A missing ``scale`` falls back to ``value`` in both
    cases, so that constant is ``value`` squared: the reference's reading
    (ROADMAP C12), copied so that the tables stay the reference's."""
    sc = (props.get_spectrum("scale", np.ones(3)) if "scale" in props
          else np.full(3, props.get_float("value", 1.0)))
    nested = props.children.get("texture", INVALID)
    if ctx is None:
        return INVALID
    if isinstance(nested, (int, np.integer)) and nested >= 0:
        return scale(ctx.textures, int(nested), sc)
    base = (props.get_spectrum("value", np.ones(3)) if "value" in props
            else np.ones(3))
    return scale(ctx.textures, INVALID, sc, base)


@register("texture", "wireframe")
def _wireframe(props: Properties, ctx=None):
    c0 = props.get_spectrum("interiorColor", np.full(3, 0.5))
    c1 = props.get_spectrum("edgeColor", np.full(3, 0.1))
    lw = props.get_float("lineWidth", 0.01)
    if ctx is None:
        return INVALID
    return wireframe(ctx.textures, c0, c1, lw)


@register("texture", "vertexcolors")
def _vertexcolors(props: Properties, ctx=None):
    return INVALID if ctx is None else vertexcolors(ctx)


@register("texture", "curvature")
def _curvature(props: Properties, ctx=None):
    return INVALID if ctx is None else curvature(ctx.textures)
