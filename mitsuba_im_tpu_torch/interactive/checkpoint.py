"""Exact mid-render checkpoint and resume
(``mitsuba_im_tpu/interactive/checkpoint.py``).

The sampler is a pure function of (seed, pixel, sample index), so the film
accumulator, the samples per pixel done and the settings are an exact
resume point: a render resumed from them is the uninterrupted render, bit
for bit where the splat is deterministic (every filter on the CPU; on the
card the box filter of radius 0.5, whose ``index_put_`` splat gave the
same film run to run, ``film/film.py``).  The ``.npz`` layout is the JAX
package's, so either package resumes the other's checkpoints.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..core.types import entry_device
from ..film.film import Film
from ..render.job import RenderSettings


def save_checkpoint(path: str, film: Film, spp_done: int,
                    settings: RenderSettings) -> None:
    np.savez_compressed(
        path if path.endswith(".npz") else path + ".npz",
        film=film.data.detach().cpu().numpy(),
        spp_done=spp_done,
        width=film.width, height=film.height,
        ftype=film.ftype, radius=film.radius,
        seed=settings.seed,
        settings=json.dumps({
            "width": settings.width, "height": settings.height,
            "spp": settings.spp, "sampler": settings.sampler,
            "seed": settings.seed, "integrator": settings.integrator,
            "integrator_props": settings.integrator_props,
            "rfilter": settings.rfilter,
            "rfilter_radius": settings.rfilter_radius,
        }),
    )


def load_checkpoint(path: str, device="cuda"
                    ) -> tuple[Film, int, RenderSettings]:
    """(film on ``device``, samples per pixel done, settings)."""
    device = entry_device(device)
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = np.load(path, allow_pickle=False)
    film = Film(
        data=torch.from_numpy(np.asarray(z["film"], np.float32)).to(device),
        width=int(z["width"]), height=int(z["height"]),
        ftype=int(z["ftype"]), radius=float(z["radius"]),
    )
    settings = RenderSettings(**json.loads(str(z["settings"])))
    return film, int(z["spp_done"]), settings
