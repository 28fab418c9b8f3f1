"""Integrator plugin factories (``mitsuba_im_tpu/integrators/__init__.py``).

``path``, ``volpath`` (and ``volpath_simple``, the same estimator),
``direct``, ``ao``, ``field``, ``motion``, ``ptracer``, ``bdpt``,
``adaptive``, ``multichannel``, ``irrcache``, ``sppm``, ``ppm`` and
``photonmapper`` (recorded as ``sppm``) and ``vpl`` record their name and
parameters into the builder's render settings, which
``render/job.py::integrator_fn`` turns into the integrator (the
integrators of ``render/job.py::LOOP_INTEGRATORS`` render through their
own loops, ``render/job.py::render``).  ``adaptive`` and ``irrcache``
keep their nested integrator's record, ``multichannel`` its children's.
``motion`` records only ``timeDelta``, as the reference's, so from a scene
file its previous sensor pose is the current one (ROADMAP C13).  Every
other integrator the JAX package registers is registered here too and
raises ``NotImplementedError`` naming its ROADMAP queue A item 7 entry
when a scene asks for it: nothing renders it with ``path`` instead.  The
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


@register("integrator", "ptracer")
def _ptracer(props: Properties, ctx=None):
    ip = _mc_props(props)
    ip["granularity"] = props.get_int("granularity", 200000)
    return _set(ctx, "ptracer", ip)


@register("integrator", "bdpt")
def _bdpt(props: Properties, ctx=None):
    ip = _mc_props(props)
    ip["light_image"] = props.get_bool("lightImage", True)
    return _set(ctx, "bdpt", ip)


@register("integrator", "adaptive")
def _adaptive(props: Properties, ctx=None):
    return _set(ctx, "adaptive", dict(
        max_error=props.get_float("maxError", 0.05),
        p_value=props.get_float("pValue", 0.05),
        max_spp=props.get_int("maxSampleFactor", 32),
        nested=props.children.get("integrator", dict(name="path"))))


@register("integrator", "multichannel")
def _multichannel(props: Properties, ctx=None):
    return _set(ctx, "multichannel", dict(
        children=props.children.get("integrator_list", [])))


@register("integrator", "irrcache")
def _irrcache(props: Properties, ctx=None):
    res = props.get_int("resolution", 14)  # the hemisphere's strata
    return _set(ctx, "irrcache", dict(
        quality=props.get_float("quality", 1.0),
        # the records' pixel stride (camera-grid placement in place of the
        # reference's on-demand octree insertion)
        resolution=props.get_int("stride", 4),
        irr_samples=min(3 * res * res, 1024),
        nested=props.children.get("integrator", dict(name="path"))))


def _photon(name):
    # photonmapper renders through the progressive engine, sppm
    @register("integrator", name)
    def make(props: Properties, ctx=None, _n=name):
        ip = _mc_props(props)
        ip["photon_count"] = props.get_int(
            "photonCount", props.get_int("globalPhotons", 250000))
        ip["initial_radius"] = props.get_float("initialRadius", 0.0)
        ip["alpha"] = props.get_float("alpha", 0.7)
        ip["lookup_radius_rel"] = props.get_float(
            "globalLookupRadiusRelative", 0.05)
        ip["iterations"] = props.get_int("maxPasses", -1)
        return _set(ctx, "sppm" if _n == "photonmapper" else _n, ip)

    return make


for _n in ("photonmapper", "ppm", "sppm"):
    _photon(_n)


@register("integrator", "vpl")
def _vpl(props: Properties, ctx=None):
    return _set(ctx, "vpl", dict(
        max_depth=props.get_int("maxDepth", 5),
        vpl_count=props.get_int(
            "vplSamples", props.get_int("shadowMapResolution", 256)),
        clamping=props.get_float("clamping", 0.1)))


register_unported("integrator", ("pssmlt", "mlt", "erpt"), "queue A item 7.8")
register_unported("subsurface", ("dipole", "singlescatter"),
                  "queue A item 7.7")
