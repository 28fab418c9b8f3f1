"""Film accumulation with reconstruction-filtered splatting
(``mitsuba_im_tpu/film/film.py``).

The film is an ``(H, W, 4)`` tensor (RGB premultiplied by the filter
weight, plus the weight).  A box-filter sample of radius <= 0.5 lands in
the one pixel its position truncates to; a jitter that rounds up to 1
moves it to the next pixel, so a pixel may take two samples of a pass.
They are summed with ``index_put_(accumulate=True)``: on the card the box
film then came out the same bit for bit from run to run and between a
render and its resumed checkpoint (``chip_smoke.py``'s ``[xml cornell]``),
where ``index_add_``'s atomics had differed in a few entries.  An inactive
sample adds zeros, at a pixel of its own lane (:func:`spread_inactive`):
``index_put_``'s accumulate walks the samples of one pixel in turn, and
the particle tracer's millions of inactive splats, clamped to a few
pixels, had taken 139 of its 159 ms of device time a pass.  Every other
filter splats each sample to its ``ceil(2 r)`` x ``ceil(2 r)``
neighbourhood (16 taps for the Gaussian at radius 2) with the separable
weight ``f(dx) f(dy)``; a tap outside the image goes to pixel 0 with
weight 0, as in the reference.  All taps of a pass are accumulated with
one ``index_add_``, in place, tap-major (the order of the reference's
per-tap scatters).  On the card ``index_add_`` is atomic, so that film
differs from the CPU's in the last bits and from run to run.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.types import Float, Int

F_BOX = 0
F_TENT = 1
F_GAUSSIAN = 2
F_MITCHELL = 3
F_CATMULLROM = 4
F_LANCZOS = 5

FILTER_NAMES = {
    "box": F_BOX, "tent": F_TENT, "gaussian": F_GAUSSIAN,
    "mitchell": F_MITCHELL, "catmullrom": F_CATMULLROM, "lanczos": F_LANCZOS,
}

# default radii per reference plugins (src/rfilters/*.cpp)
DEFAULT_RADIUS = {
    F_BOX: 0.5, F_TENT: 1.0, F_GAUSSIAN: 2.0, F_MITCHELL: 2.0,
    F_CATMULLROM: 2.0, F_LANCZOS: 3.0,
}


def filter_eval(ftype: int, x: torch.Tensor, radius: float) -> torch.Tensor:
    """1D filter kernel (all reference filters are separable here; the
    gaussian is the reference's truncated form with stddev radius / 4)."""
    ax = torch.abs(x)
    if ftype == F_BOX:
        return torch.where(ax <= radius, 1.0, 0.0)
    if ftype == F_TENT:
        return torch.clamp_min(1.0 - ax / radius, 0.0)
    if ftype == F_GAUSSIAN:
        stddev = radius / 4.0
        alpha = -1.0 / (2.0 * stddev * stddev)
        return torch.clamp_min(torch.exp(alpha * ax * ax)
                               - math.exp(alpha * radius * radius), 0.0)
    if ftype in (F_MITCHELL, F_CATMULLROM):
        B, C = (1.0 / 3.0, 1.0 / 3.0) if ftype == F_MITCHELL else (0.0, 0.5)
        t = ax * 2.0 / radius  # normalized to [0, 2]
        t2, t3 = t * t, t * t * t
        inner = ((12 - 9 * B - 6 * C) * t3 + (-18 + 12 * B + 6 * C) * t2
                 + (6 - 2 * B)) * (1.0 / 6.0)
        outer = ((-B - 6 * C) * t3 + (6 * B + 30 * C) * t2
                 + (-12 * B - 48 * C) * t + (8 * B + 24 * C)) * (1.0 / 6.0)
        return torch.where(t < 1.0, inner, torch.where(t < 2.0, outer, 0.0))
    if ftype == F_LANCZOS:
        tau = 3.0
        t = ax * tau / radius
        small = ax < 1e-6
        pit = math.pi * torch.where(small, 1.0, t)
        sinc = torch.where(small, 1.0, torch.sin(pit) / pit)
        pitt = pit / tau
        window = torch.where(small, 1.0, torch.sin(pitt) / pitt)
        return torch.where(t < tau, sinc * window, 0.0)
    raise ValueError(ftype)


@dataclasses.dataclass(frozen=True)
class Film:
    data: torch.Tensor  # (H, W, 4)
    width: int = 0
    height: int = 0
    ftype: int = F_GAUSSIAN
    radius: float = 2.0


def make_film(width: int, height: int, ftype: int = F_GAUSSIAN,
              radius: float | None = None, *, device) -> Film:
    if radius is None:
        radius = DEFAULT_RADIUS[ftype]
    return Film(data=torch.zeros((height, width, 4), dtype=Float,
                                 device=device),
                width=width, height=height, ftype=ftype, radius=float(radius))


def splat(film: Film, px: torch.Tensor, py: torch.Tensor, value,
          active: torch.Tensor | None = None) -> Film:
    """Accumulate samples in place.  px, py: (N,) continuous film
    coordinates in pixels; value: V3 of (N,) radiance."""
    ones = torch.ones_like(px)
    masked = active is not None
    if not masked:
        active = torch.ones(px.shape, dtype=torch.bool, device=px.device)
    cols = [torch.where(active, c, 0.0) for c in value] + [
        torch.where(active, ones, 0.0)]
    H, W = film.height, film.width
    flat = film.data.view(-1, 4)
    if film.ftype == F_BOX and film.radius <= 0.5:
        ix = torch.clamp(px.to(Int), 0, W - 1)
        iy = torch.clamp(py.to(Int), 0, H - 1)
        idx = iy * W + ix
        if masked:
            idx = spread_inactive(idx, active, H * W)
        flat.index_put_((idx,), torch.stack(cols, dim=-1), accumulate=True)
        return film

    r = film.radius
    supp = int(math.ceil(2 * r))  # taps per axis
    taps = torch.arange(supp, dtype=Int, device=px.device)[:, None]
    x0 = torch.floor(px - r + 0.5).to(Int)
    y0 = torch.floor(py - r + 0.5).to(Int)
    tx = x0 + taps  # (supp, N) tap columns and rows
    ty = y0 + taps
    fx = filter_eval(film.ftype, tx.to(Float) + 0.5 - px, r)
    fy = filter_eval(film.ftype, ty.to(Float) + 0.5 - py, r)
    in_x = (tx >= 0) & (tx < W)
    in_y = (ty >= 0) & (ty < H)
    # taps in the reference's order: dy outer, dx inner
    inside = in_y[:, None] & in_x[None] & active
    w = torch.where(inside, fy[:, None] * fx[None], 0.0)
    idx = torch.where(inside, ty[:, None] * W + tx[None], 0)
    upd = torch.stack([torch.where(inside, c * w, 0.0) for c in cols],
                      dim=-1)
    flat.index_add_(0, idx.reshape(-1), upd.reshape(-1, 4))
    return film


def spread_inactive(idx: torch.Tensor, active: torch.Tensor,
                    n_pixels: int) -> torch.Tensor:
    """Accumulation indices with each inactive sample (whose values are
    zeros) sent to pixel lane mod n_pixels: the same sums, without the
    serialized run of duplicates that a pile of them at one pixel costs
    ``index_put_``."""
    lane = torch.arange(idx.shape[0], device=idx.device) % n_pixels
    return torch.where(active, idx, lane)


def develop(film: Film) -> torch.Tensor:
    """Weighted average -> (H, W, 3) radiance image (Film::develop)."""
    w = film.data[..., 3:4]
    return torch.where(w > 0, film.data[..., :3] / torch.clamp_min(w, 1e-12),
                       0.0)


def merge(films: list[Film]) -> Film:
    """Combine per-worker or per-device films (the sum of their data)."""
    out = films[0]
    for f in films[1:]:
        out = dataclasses.replace(out, data=out.data + f.data)
    return out
