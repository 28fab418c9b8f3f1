"""Sampler factories (``mitsuba_im_tpu/sampler/__init__.py``), taking
keyword arguments where the reference reads a ``Properties`` bag.

Every sampler shares the stateless counter-based substrate of
:mod:`..core.rng`; the plugin picks the stratification or low-discrepancy
strategy.  A factory returns ``dict(kind, spp, scramble)`` and, given a
``RenderSettings``, sets its ``spp``, ``sampler`` name and ``seed`` (the
scramble), as the reference's scene context does.
"""
from __future__ import annotations

from ..core import rng as mrng

NAMES = {
    mrng.INDEPENDENT: "independent",
    mrng.STRATIFIED: "stratified",
    mrng.LDSAMPLER: "ldsampler",
    mrng.SOBOL: "sobol",
    mrng.HALTON: "halton",
    mrng.HAMMERSLEY: "hammersley",
}
KIND_BY_NAME = {v: k for k, v in NAMES.items()}


def _factory(kind: int):
    def make(sample_count: int = 4, scramble: int = 0,
             settings=None) -> dict:
        cfg = dict(kind=kind, spp=int(sample_count), scramble=int(scramble))
        if settings is not None:
            settings.spp = cfg["spp"]
            settings.sampler = NAMES[kind]
            settings.seed = cfg["scramble"]
        return cfg

    make.__name__ = make.__qualname__ = NAMES[kind]
    make.__doc__ = (f"The ``{NAMES[kind]}`` sampler: ``sample_count`` "
                    "samples per pixel, scrambled by ``scramble``.")
    return make


independent = _factory(mrng.INDEPENDENT)
stratified = _factory(mrng.STRATIFIED)
ldsampler = _factory(mrng.LDSAMPLER)
sobol = _factory(mrng.SOBOL)
halton = _factory(mrng.HALTON)
hammersley = _factory(mrng.HAMMERSLEY)
