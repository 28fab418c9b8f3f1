"""Texture record factories (``mitsuba_im_tpu/texture/__init__.py``), taking
keyword arguments where the reference reads a ``Properties`` bag.

Each factory adds its record to a :class:`~.texture.TextureBuilder` (a
``SceneBuilder``'s ``textures``) and returns the texture id that a BSDF
record's ``*_tex`` column takes.  Bitmaps come from pixel arrays; loading
image files is not ported.
"""
from __future__ import annotations

import warnings

import numpy as np

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


def curvature(*_, **__):
    """``curvature`` needs per-vertex curvature, which the reference
    replaces by a constant; it is not ported."""
    raise NotImplementedError("the curvature texture is not ported")


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
