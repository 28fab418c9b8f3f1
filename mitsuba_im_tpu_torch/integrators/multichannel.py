"""Multi-channel rendering (``mitsuba_im_tpu/integrators/multichannel.py``,
after ``src/integrators/misc/multichannel.cpp``).

Each child integrator renders the image on its own, from the same sample
streams (children are independent estimators, so one after another gives
the channels of the reference's interleaved evaluation), and the images
stack into named EXR layers: the first child is R, G, B, the primary
image of an LDR output, and every further child ``<layer>.R/G/B``, its
layer named after its integrator (``path``, ``path2``, ...).
"""
from __future__ import annotations

import numpy as np


def render_multichannel(scene, settings, spp=None):
    """Render every child; returns the first child's image (a tensor on
    the scene's device) and leaves (channel names, the (H, W, 3 x
    children) stack) on ``settings.aux_channels`` for the EXR writer
    (``render/job.py::save_render``)."""
    from ..render.job import RenderSettings, render

    children = settings.integrator_props.get("children", []) or [
        dict(name="path")]
    images, names, used = [], [], {}
    for child in children:
        child = dict(child)
        cname = child.pop("name", "path")
        sub = RenderSettings(
            width=settings.width, height=settings.height, spp=settings.spp,
            sampler=settings.sampler, seed=settings.seed, integrator=cname,
            integrator_props=child, rfilter=settings.rfilter,
            rfilter_radius=settings.rfilter_radius)
        images.append(render(scene, sub, spp=spp))
        used[cname] = used.get(cname, 0) + 1
        names.append(cname if used[cname] == 1 else f"{cname}{used[cname]}")

    channel_names = ["R", "G", "B"]
    for layer in names[1:]:
        channel_names += [f"{layer}.R", f"{layer}.G", f"{layer}.B"]
    stack = np.concatenate([im.cpu().numpy() for im in images], axis=-1)
    settings.aux_channels = (channel_names, stack)
    return images[0]
