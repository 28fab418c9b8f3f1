"""Render orchestration: samples -> integrator -> film
(``mitsuba_im_tpu/render/job.py``), for the ``path`` integrator.

The whole image is one flat wavefront; each pass takes one sample per
pixel (``_render_pass``, the reference's job.py:88-121), with the primary
rays' differentials when the scene's textures have MIP pyramids, and
splats it into the film in place, through the settings' reconstruction
filter (the Gaussian of radius 2 by default, as the reference's).  Every
sampler kind draws the pass; its stratification reads the call's ``spp``,
as the reference's ``render_film`` passes it.  Other integrators raise.

The develop and output half (``tonemap_ldr``, ``save_render``) is the
reference's host numpy: EXR as the JAX package writes it, PNG/PPM through
its exposure, Reinhard and sRGB/gamma chain.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.types import Float
from ..core import rng as mrng
from ..core.v3 import V3
from ..film.film import F_GAUSSIAN, Film, make_film, splat
from ..integrators.path import PathConfig, path_li_v
from .raydiff import camera_ray_differentials
from ..sensor.table import sample_ray_v
from ..sampler import KIND_BY_NAME
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
    rfilter: int = F_GAUSSIAN
    rfilter_radius: float | None = None
    film_format: str = "exr"
    banner: bool = False
    gamma: float = -1.0  # ldrfilm: <= 0 means sRGB
    tonemap: str = "gamma"
    exposure: float = 0.0
    key: float = 0.18


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


def sampler_kind(settings: RenderSettings) -> int:
    """The sampler kind of the settings' sampler name (the reference's
    ``KIND_BY_NAME.get(settings.sampler, INDEPENDENT)``)."""
    return KIND_BY_NAME.get(settings.sampler, mrng.INDEPENDENT)


def render_pass(scene: Scene, film: Film, sample_idx: int, seed: int,
                cfg: PathConfig, kind: int, spp: int) -> Film:
    """One sample-per-pixel pass over the full image, splatted into film;
    ``kind`` and ``spp`` set the sampler."""
    W, H = film.width, film.height
    pix = torch.arange(W * H, dtype=torch.int64, device=scene.device)
    sampler = mrng.make_sampler_v(pix, sample_idx, seed, kind=kind, spp=spp)
    sampler, blk0 = mrng.next_block4_v(sampler)
    px = (pix % W).to(Float) + blk0[0]
    py = (pix // W).to(Float) + blk0[1]
    o, d, w_sensor = sample_ray_v(scene.sensor, px / W, py / H,
                                  blk0[2], blk0[3])
    diffs = {}
    if scene.textures.has_mip:
        # primary-ray differentials for the MIP/anisotropic texture filter
        dddx, dddy = camera_ray_differentials(
            scene.sensor, px / W, py / H, blk0[2], blk0[3], 1.0 / W, 1.0 / H)
        diffs = dict(dddx=dddx, dddy=dddy)
    li, _ = path_li_v(scene, sampler, o, d, cfg, **diffs)
    li = V3(*(torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0) * w_sensor
              for c in li))
    return splat(film, px, py, li)


def render_film(scene: Scene, settings: RenderSettings, spp: int | None = None,
                film: Film | None = None, sample_offset: int = 0,
                progress_cb=None) -> Film:
    """Render ``spp`` passes into a (new or given) film.  Forward only, as
    the reference's ``render``: the passes run under ``torch.no_grad``.
    ``progress_cb(done, spp, film)`` runs after each pass."""
    spp = spp if spp is not None else settings.spp
    kind = sampler_kind(settings)
    cfg = path_config(settings)
    if film is None:
        film = make_film(settings.width, settings.height, settings.rfilter,
                         settings.rfilter_radius, device=scene.device)
    with torch.no_grad():
        for s in range(spp):
            film = render_pass(scene, film, sample_offset + s, settings.seed,
                               cfg, kind, spp)
            if progress_cb is not None:
                progress_cb(s + 1, spp, film)
    return film


def tonemap_ldr(img: np.ndarray, settings: RenderSettings) -> np.ndarray:
    """The ldrfilm develop chain (films/ldrfilm.cpp): exposure, optional
    Reinhard, then sRGB (``gamma`` <= 0) or a power gamma, in [0, 1]."""
    img = np.asarray(img, np.float32) * (2.0 ** settings.exposure)
    if settings.tonemap == "reinhard":
        lum = (img[..., 0] * 0.212671 + img[..., 1] * 0.715160
               + img[..., 2] * 0.072169)
        avg = np.exp(np.mean(np.log(np.maximum(lum, 1e-6))))
        scaled = img * (settings.key / max(avg, 1e-9))
        img = scaled / (1.0 + scaled)
    g = settings.gamma
    if g <= 0:
        c = np.clip(img, 0, 1)
        img = np.where(c <= 0.0031308, c * 12.92,
                       1.055 * c ** (1 / 2.4) - 0.055)
    else:
        img = np.clip(img, 0, 1) ** (1.0 / g)
    return np.clip(img, 0.0, 1.0)


def save_render(path: str, img, settings: RenderSettings,
                metadata: dict | None = None) -> None:
    """Write a developed (H, W, 3) image (a tensor on any device, or numpy)
    by the extension of ``path``; PNG, JPEG and PPM go through
    :func:`tonemap_ldr`."""
    from ..io import bitmap as bmp

    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    if os.path.splitext(path)[1].lower() in (".png", ".jpg", ".ppm"):
        img = tonemap_ldr(img, settings)
    bmp.save(path, img, metadata=metadata)
