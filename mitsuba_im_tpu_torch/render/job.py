"""Render orchestration: samples -> integrator -> film
(``mitsuba_im_tpu/render/job.py``), for the ``path`` integrator.

The whole image is one flat wavefront; each pass takes one sample per
pixel (``_render_pass``, the reference's job.py:88-121) and splats it into
the film in place.  Other integrators and samplers raise.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.types import Float
from ..core import rng as mrng
from ..core.v3 import V3
from ..film.film import F_BOX, Film, make_film, splat
from ..integrators.path import PathConfig, path_li_v
from ..sensor.table import sample_ray_v
from ..scene.scene import Scene


@dataclasses.dataclass
class RenderSettings:
    width: int = 256
    height: int = 256
    spp: int = 16
    sampler: str = "independent"
    seed: int = 0
    integrator: str = "path"
    integrator_props: dict = dataclasses.field(default_factory=dict)
    rfilter: int = F_BOX
    rfilter_radius: float | None = None


def path_config(settings: RenderSettings) -> PathConfig:
    """The integrator configuration of a render (the reference's
    ``_integrator_fn`` for ``path``; forward rendering runs without remat)."""
    if settings.integrator != "path":
        raise NotImplementedError(
            f"integrator '{settings.integrator}': only 'path' is ported")
    ip = settings.integrator_props
    return PathConfig(
        max_depth=ip.get("max_depth", -1),
        rr_depth=ip.get("rr_depth", 5),
        hide_emitters=ip.get("hide_emitters", False),
        remat=False,
    )


def render_pass(scene: Scene, film: Film, sample_idx: int, seed: int,
                cfg: PathConfig) -> Film:
    """One sample-per-pixel pass over the full image, splatted into film."""
    W, H = film.width, film.height
    pix = torch.arange(W * H, dtype=torch.int64, device=scene.device)
    sampler = mrng.make_sampler_v(pix, sample_idx, seed)
    sampler, blk0 = mrng.next_block4_v(sampler)
    px = (pix % W).to(Float) + blk0[0]
    py = (pix // W).to(Float) + blk0[1]
    o, d, w_sensor = sample_ray_v(scene.sensor, px / W, py / H,
                                  blk0[2], blk0[3])
    li, _ = path_li_v(scene, sampler, o, d, cfg)
    li = V3(*(torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0) * w_sensor
              for c in li))
    return splat(film, px, py, li)


def render_film(scene: Scene, settings: RenderSettings, spp: int | None = None,
                film: Film | None = None, sample_offset: int = 0) -> Film:
    """Render ``spp`` passes into a (new or given) film.  Forward only, as
    the reference's ``render``: the passes run under ``torch.no_grad``."""
    spp = spp if spp is not None else settings.spp
    if settings.sampler != "independent":
        raise NotImplementedError(
            f"sampler '{settings.sampler}': only 'independent' is ported")
    cfg = path_config(settings)
    if film is None:
        film = make_film(settings.width, settings.height, settings.rfilter,
                         settings.rfilter_radius, device=scene.device)
    with torch.no_grad():
        for s in range(spp):
            film = render_pass(scene, film, sample_offset + s, settings.seed,
                               cfg)
    return film
