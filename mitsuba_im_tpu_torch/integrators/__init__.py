"""Integrator plugin factories (``mitsuba_im_tpu/integrators/__init__.py``).

``path``, ``volpath`` (and ``volpath_simple``, the same estimator),
``direct``, ``ao``, ``field`` and ``motion`` record their name
and parameters into the builder's render settings, which
``render/job.py::integrator_fn`` turns into the integrator.  ``motion``
records only ``timeDelta``, as the reference's, so from a scene file its
previous sensor pose is the current one (ROADMAP C13).  Every other
integrator the JAX package registers is registered here too and raises
``NotImplementedError`` naming its ROADMAP queue A item 7 entry when a
scene asks for it: nothing renders it with ``path`` instead.  The
subsurface integrators belong to entry 7.7 and raise the same way.
"""
from __future__ import annotations

from ..core.properties import Properties
from ..core.registry import register, register_unported


def _mc_props(props: Properties) -> dict:
    return dict(
        max_depth=props.get_int("maxDepth", -1),
        rr_depth=props.get_int("rrDepth", 5),
        strict_normals=props.get_bool("strictNormals", False),
        hide_emitters=props.get_bool("hideEmitters", False),
    )


def _set(ctx, name, ip):
    if ctx is not None:
        ctx.settings.integrator = name
        ctx.settings.integrator_props = ip
    return dict(name=name, **ip)


@register("integrator", "path")
def _path(props: Properties, ctx=None):
    return _set(ctx, "path", _mc_props(props))


@register("integrator", "volpath")
@register("integrator", "volpath_simple")
def _volpath(props: Properties, ctx=None):
    return _set(ctx, "volpath", _mc_props(props))


@register("integrator", "direct")
def _direct(props: Properties, ctx=None):
    shading = props.get_int("shadingSamples", 1)
    return _set(ctx, "direct", dict(
        emitter_samples=props.get_int("emitterSamples", shading),
        bsdf_samples=props.get_int("bsdfSamples", shading),
        strict_normals=props.get_bool("strictNormals", False),
        hide_emitters=props.get_bool("hideEmitters", False)))


@register("integrator", "ao")
def _ao(props: Properties, ctx=None):
    return _set(ctx, "ao", dict(
        shading_samples=props.get_int("shadingSamples", 1),
        ray_length=props.get_float("rayLength", -1.0)))


@register("integrator", "field")
def _field(props: Properties, ctx=None):
    return _set(ctx, "field", dict(field=props.get_string("field",
                                                          "position")))


@register("integrator", "motion")
def _motion(props: Properties, ctx=None):
    return _set(ctx, "motion", dict(
        time_delta=props.get_float("timeDelta", 1.0 / 24.0)))


for _names, _item in (
        (("ptracer",), "queue A item 7.3"),
        (("bdpt",), "queue A item 7.4"),
        (("adaptive", "multichannel"), "queue A item 7.5"),
        (("photonmapper", "ppm", "sppm", "vpl", "irrcache"),
         "queue A item 7.6"),
        (("pssmlt", "mlt", "erpt"), "queue A item 7.8")):
    register_unported("integrator", _names, _item)

register_unported("subsurface", ("dipole", "singlescatter"),
                  "queue A item 7.7")
