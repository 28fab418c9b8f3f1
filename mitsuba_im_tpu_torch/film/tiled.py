"""Out-of-core tiled film (``mitsuba_im_tpu/film/tiled.py``, the
reference's ``tiledhdrfilm``): the image renders in horizontal bands, each
a small film on the device covering ``band_rows`` rows plus the filter's
margin above and below (``render/job.py::render_band``); after a band's
passes it is added into a float32 memmap on the host and its device film
is dropped, and the develop streams the memmap's rows into the scanline
EXR writer (``io/exr.py::write_exr_stream``).  Device memory is one band
whatever the image size; host memory is the memmap's pages in use.

The band passes draw the same samples as ``render_film``'s (the sampler
is keyed by the global pixel), without ray differentials (see
``render/job.py``).  A pixel's weight sums the bands that reach it in band
order, so the tiled image equals the full-frame one to rounding.
"""
from __future__ import annotations

import math
import os
import tempfile

import numpy as np
import torch

from ..core.types import Float
from .film import DEFAULT_RADIUS, Film


def render_tiled(scene, settings, out_path: str, spp: int | None = None,
                 band_rows: int = 64, half: bool = True,
                 metadata: dict | None = None) -> str:
    """Render ``scene`` band by band and write ``out_path`` (EXR)."""
    from ..io.exr import write_exr_stream
    from ..render.job import integrator_fn, render_band, sampler_kind

    W, H = settings.width, settings.height
    spp = spp if spp is not None else settings.spp
    radius = settings.rfilter_radius or DEFAULT_RADIUS[settings.rfilter]
    margin = int(math.ceil(radius))
    kind = sampler_kind(settings)
    li_fn = integrator_fn(settings)

    tmp = tempfile.NamedTemporaryFile(suffix=".npy", delete=False,
                                      dir=os.path.dirname(
                                          os.path.abspath(out_path)))
    tmp.close()
    try:
        acc = np.lib.format.open_memmap(tmp.name, mode="w+",
                                        dtype=np.float32, shape=(H, W, 4))
        acc[:] = 0.0
        band_h = band_rows + 2 * margin
        with torch.no_grad():
            for row0 in range(0, H, band_rows):
                band = Film(data=torch.zeros((band_h, W, 4), dtype=Float,
                                             device=scene.device),
                            width=W, height=band_h, ftype=settings.rfilter,
                            radius=float(radius))
                for s in range(spp):
                    band = render_band(scene, band, s, settings.seed, row0,
                                       W, H, margin, li_fn, kind, spp)
                host = band.data.cpu().numpy()
                lo = max(row0 - margin, 0)
                hi = min(row0 + band_rows + margin, H)
                acc[lo:hi] += host[lo - (row0 - margin):
                                   hi - (row0 - margin)]

        def rows(y0, n):
            blk = acc[y0:y0 + n]
            return blk[..., :3] / np.maximum(blk[..., 3:4], 1e-8)

        write_exr_stream(out_path, rows, H, W, 3, half=half,
                         metadata=metadata)
        acc._mmap.close()
    finally:
        os.unlink(tmp.name)
    return out_path
