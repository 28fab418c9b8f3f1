"""Render orchestration: samples -> integrator -> film
(``mitsuba_im_tpu/render/job.py``).

The whole image is one flat wavefront; each pass takes one sample per
pixel (``_render_pass``, the reference's job.py:88-121), with the primary
rays' differentials when the scene's textures have MIP pyramids, and
splats it into the film in place, through the settings' reconstruction
filter (the Gaussian of radius 2 by default, as the reference's).  Every
sampler kind draws the pass; its stratification reads the call's ``spp``,
as the reference's ``render_film`` passes it.  The integrator comes from
the settings (:func:`integrator_fn`, the reference's ``_integrator_fn``):
``path`` (``integrators/path.py``), ``volpath`` (``integrators/volpath.py``),
and ``direct``, ``ao``, ``field`` and ``motion``
(``integrators/simple.py``); the others raise.  A scene with
deformable shapes renders each pass at one shutter time,
``shutter_open + shutter_time * u`` with ``u`` the pass index's golden-ratio
word (:func:`shutter_time`), shared by the pass's wavefront.  The port
computes it on the host in float32, one rounding per operation, so that
the hierarchy kernel takes it as a number; the reference computes it on
the device, where XLA may contract it into one fused multiply-add (the
two agree whenever the shutter opens at 0).  A ``sensor_animation`` in
the motion integrator's properties raises: no factory of either package
sets one (ROADMAP C13) and animated transforms are not ported.

:func:`render_band` is one pass over a band of rows of a tiled film
(``film/tiled.py``; the reference's ``_render_band``, job.py:130-157).  It
computes no ray differentials, as the reference's does not, so a textured
scene with MIP pyramids filters its bitmaps at the finest level there and
differs from ``render_film``'s image in the filtered texels.

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
from ..integrators import simple
from ..integrators.volpath import volpath_li_v
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
    tiled: bool = False  # tiledhdrfilm: out-of-core band rendering

INTEGRATORS = ("path", "volpath", "direct", "ao", "field", "motion")


def path_config(settings: RenderSettings) -> PathConfig:
    """The path integrator's configuration of a render (forward rendering
    runs without remat)."""
    ip = settings.integrator_props
    return PathConfig(
        max_depth=ip.get("max_depth", -1),
        rr_depth=ip.get("rr_depth", 5),
        hide_emitters=ip.get("hide_emitters", False),
        remat=False,
    )


def integrator_fn(settings: RenderSettings):
    """fn(scene, sampler, o, d, **diffs) -> (radiance V3, sampler) of the
    settings' integrator (the reference's ``_integrator_fn``); only
    ``path`` reads the primary rays' differentials."""
    name = settings.integrator
    ip = settings.integrator_props
    if name == "path":
        cfg = path_config(settings)
        return lambda scene, s, o, d, **kw: path_li_v(scene, s, o, d, cfg,
                                                      **kw)
    if name == "volpath":
        cfg = path_config(settings)
        return lambda scene, s, o, d, **kw: volpath_li_v(scene, s, o, d,
                                                         cfg)
    if name == "direct":
        return lambda scene, s, o, d, **kw: simple.direct_li_v(
            scene, s, o, d, emitter_samples=ip.get("emitter_samples", 1),
            bsdf_samples=ip.get("bsdf_samples", 1),
            hide_emitters=ip.get("hide_emitters", False))
    if name == "ao":
        return lambda scene, s, o, d, **kw: simple.ao_li_v(
            scene, s, o, d, shading_samples=ip.get("shading_samples", 1),
            ray_length=ip.get("ray_length", -1.0))
    if name == "field":
        return lambda scene, s, o, d, **kw: simple.field_li_v(
            scene, s, o, d, ip.get("field", "position"))
    if name == "motion":
        prev = ip.get("prev_to_world")
        if prev is None and ip.get("sensor_animation") is not None:
            raise NotImplementedError(
                "a sensor animation for the motion integrator: animated "
                "transforms are not ported")
        return lambda scene, s, o, d, **kw: simple.motion_li_v(
            scene, s, o, d, prev_to_world=prev, width=settings.width,
            height=settings.height)
    raise NotImplementedError(
        f"integrator '{name}': the port renders {', '.join(INTEGRATORS)}")


def shutter_time(scene: Scene, sample_idx: int) -> float:
    """The shutter time of pass ``sample_idx``: shutter_open + shutter_time
    * u, u = float32(uint32(sample_idx * 2654435769)) / 2^32, in float32 as
    the reference computes it (job.py:102-106), from the sensor's shutter
    as the scene's build read it to the host (``Scene.shutter``)."""
    u = np.float32(np.uint32((int(sample_idx) * 2654435769) & 0xFFFFFFFF))
    u = u / np.float32(4294967296.0)
    shutter_open, shutter_len = (np.float32(x) for x in scene.shutter)
    return float(shutter_open + shutter_len * u)


def sampler_kind(settings: RenderSettings) -> int:
    """The sampler kind of the settings' sampler name (the reference's
    ``KIND_BY_NAME.get(settings.sampler, INDEPENDENT)``)."""
    return KIND_BY_NAME.get(settings.sampler, mrng.INDEPENDENT)


def _camera_sample(scene: Scene, pix: torch.Tensor, width: int,
                   height: int, sample_idx: int, seed: int, kind: int,
                   spp: int):
    """The pass's sampler after its first block, the film positions (px,
    py) of the pixels ``pix`` and their camera rays (o, d, weight), and the
    scene at the pass's shutter time; (u_lens, film uv) for the
    differentials."""
    sampler = mrng.make_sampler_v(pix, sample_idx, seed, kind=kind, spp=spp)
    sampler, blk0 = mrng.next_block4_v(sampler)
    px = (pix % width).to(Float) + blk0[0]
    py = (pix // width).to(Float) + blk0[1]
    if scene.motion is not None:
        scene = scene.with_time(shutter_time(scene, sample_idx))
    o, d, w_sensor = sample_ray_v(scene.sensor, px / width, py / height,
                                  blk0[2], blk0[3])
    return scene, sampler, px, py, (o, d, w_sensor), blk0


def render_pass(scene: Scene, film: Film, sample_idx: int, seed: int,
                li_fn, kind: int, spp: int) -> Film:
    """One sample-per-pixel pass over the full image, splatted into film;
    ``li_fn`` is the integrator (:func:`integrator_fn`), ``kind`` and
    ``spp`` set the sampler."""
    W, H = film.width, film.height
    pix = torch.arange(W * H, dtype=torch.int64, device=scene.device)
    scene, sampler, px, py, (o, d, w_sensor), blk0 = _camera_sample(
        scene, pix, W, H, sample_idx, seed, kind, spp)
    diffs = {}
    if scene.textures.has_mip:
        # primary-ray differentials for the MIP/anisotropic texture filter
        dddx, dddy = camera_ray_differentials(
            scene.sensor, px / W, py / H, blk0[2], blk0[3], 1.0 / W, 1.0 / H)
        diffs = dict(dddx=dddx, dddy=dddy)
    li, _ = li_fn(scene, sampler, o, d, **diffs)
    li = V3(*(torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0) * w_sensor
              for c in li))
    return splat(film, px, py, li)


def render_band(scene: Scene, band: Film, sample_idx: int, seed: int,
                row0: int, width: int, height: int, margin: int, li_fn,
                kind: int, spp: int) -> Film:
    """One pass over the rows [row0, row0 + band_rows) of a ``width`` x
    ``height`` image, splatted into ``band``, a film of band_rows + 2
    ``margin`` rows whose row 0 is image row ``row0 - margin``
    (``_render_band``); pixels past the image's last row splat nothing."""
    n = width * (band.height - 2 * margin)
    pix = row0 * width + torch.arange(n, dtype=torch.int64,
                                      device=scene.device)
    in_img = pix < width * height
    scene, sampler, px, py, (o, d, w_sensor), _ = _camera_sample(
        scene, pix, width, height, sample_idx, seed, kind, spp)
    li, _ = li_fn(scene, sampler, o, d)
    li = V3(*(torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0) * w_sensor
              for c in li))
    return splat(band, px, py - float(row0 - margin), li, active=in_img)


def render_film(scene: Scene, settings: RenderSettings, spp: int | None = None,
                film: Film | None = None, sample_offset: int = 0,
                progress_cb=None) -> Film:
    """Render ``spp`` passes into a (new or given) film.  Forward only, as
    the reference's ``render``: the passes run under ``torch.no_grad``.
    ``progress_cb(done, spp, film)`` runs after each pass."""
    spp = spp if spp is not None else settings.spp
    kind = sampler_kind(settings)
    li_fn = integrator_fn(settings)
    if film is None:
        film = make_film(settings.width, settings.height, settings.rfilter,
                         settings.rfilter_radius, device=scene.device)
    with torch.no_grad():
        for s in range(spp):
            film = render_pass(scene, film, sample_offset + s, settings.seed,
                               li_fn, kind, spp)
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
