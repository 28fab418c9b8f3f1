"""Film accumulation (``mitsuba_im_tpu/film/film.py``): the box filter.

The film is an ``(H, W, 4)`` tensor (RGB premultiplied by the filter
weight, plus the weight).  A box-filter sample of radius <= 0.5 lands in
exactly one pixel and is accumulated with ``index_add_``, in place.  Other
reconstruction filters are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.types import Float, Int

F_BOX = 0
F_TENT = 1
F_GAUSSIAN = 2
F_MITCHELL = 3
F_CATMULLROM = 4
F_LANCZOS = 5

DEFAULT_RADIUS = {
    F_BOX: 0.5, F_TENT: 1.0, F_GAUSSIAN: 2.0, F_MITCHELL: 2.0,
    F_CATMULLROM: 2.0, F_LANCZOS: 3.0,
}


@dataclasses.dataclass(frozen=True)
class Film:
    data: torch.Tensor  # (H, W, 4)
    width: int = 0
    height: int = 0
    ftype: int = F_BOX
    radius: float = 0.5


def make_film(width: int, height: int, ftype: int = F_BOX,
              radius: float | None = None, *, device) -> Film:
    if radius is None:
        radius = DEFAULT_RADIUS[ftype]
    if ftype != F_BOX or radius > 0.5:
        raise NotImplementedError(
            "only the box reconstruction filter (radius <= 0.5) is ported")
    return Film(data=torch.zeros((height, width, 4), dtype=Float,
                                 device=device),
                width=width, height=height, ftype=ftype, radius=float(radius))


def splat(film: Film, px: torch.Tensor, py: torch.Tensor, value,
          active: torch.Tensor | None = None) -> Film:
    """Accumulate samples in place.  px, py: (N,) continuous film
    coordinates in pixels; value: V3 of (N,) radiance."""
    ones = torch.ones_like(px)
    if active is None:
        active = torch.ones(px.shape, dtype=torch.bool, device=px.device)
    upd = torch.stack([torch.where(active, c, 0.0) for c in value]
                      + [torch.where(active, ones, 0.0)], dim=-1)
    H, W = film.height, film.width
    ix = torch.clamp(px.to(Int), 0, W - 1)
    iy = torch.clamp(py.to(Int), 0, H - 1)
    film.data.view(-1, 4).index_add_(0, iy * W + ix, upd)
    return film


def develop(film: Film) -> torch.Tensor:
    """Weighted average -> (H, W, 3) radiance image (Film::develop)."""
    w = film.data[..., 3:4]
    return torch.where(w > 0, film.data[..., :3] / torch.clamp_min(w, 1e-12),
                       0.0)
