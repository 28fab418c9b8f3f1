"""Sampler factories (``mitsuba_im_tpu/sampler/__init__.py``): the keyword
factories, and the registered plugins that read ``sampleCount`` and
``scramble`` from a ``Properties`` bag and set the builder's settings.

Every sampler shares the stateless counter-based substrate of
:mod:`..core.rng`; the plugin picks the stratification or low-discrepancy
strategy.  A factory returns ``dict(kind, spp, scramble)`` and, given a
``RenderSettings``, sets its ``spp``, ``sampler`` name and ``seed`` (the
scramble), as the reference's scene context does.
"""
from __future__ import annotations

from ..core import rng as mrng
from ..core.properties import Properties
from ..core.registry import register

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


def _plugin(factory):
    def make(props: Properties, ctx=None):
        return factory(props.get_int("sampleCount", 4),
                       props.get_int("scramble", 0),
                       None if ctx is None else ctx.settings)

    return make


for _make in (independent, stratified, ldsampler, sobol, halton, hammersley):
    register("sampler", _make.__name__)(_plugin(_make))
