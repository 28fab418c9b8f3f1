"""Integrator plugin factories (``mitsuba_im_tpu/integrators/__init__.py``).

``path``, ``volpath`` (and ``volpath_simple``, the same estimator),
``direct``, ``ao``, ``field``, ``motion``, ``ptracer``, ``bdpt``,
``adaptive``, ``multichannel``, ``irrcache``, ``sppm``, ``ppm`` and
``photonmapper`` (recorded as ``sppm``), ``vpl``, ``pssmlt``, ``mlt`` and
``erpt`` record their name and parameters into the builder's render
settings, which
``render/job.py::integrator_fn`` turns into the integrator (the
integrators of ``render/job.py::LOOP_INTEGRATORS`` render through their
own loops, ``render/job.py::render``).  ``adaptive`` and ``irrcache``
keep their nested integrator's record, ``multichannel`` its children's.
``motion`` records only ``timeDelta``, as the reference's, so from a scene
file its previous sensor pose is the current one (ROADMAP C13); from
code, ``integrator_props["sensor_animation"]`` (a
``core/track.py::AnimatedTransform``) gives it one.  These are every
integrator the JAX package registers.
``pssmlt`` and ``erpt`` also read the reference Mitsuba's
``bidirectional`` flag where a scene file sets it (the JAX factories drop
it, so there pssmlt is always bidirectional and erpt never; ROADMAP C23);
without it their properties are the JAX factories' exactly.
"""
from __future__ import annotations

from ..core.properties import Properties
from ..core.registry import register


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


def _bidirectional(props: Properties, ip: dict) -> dict:
    if "bidirectional" in props:
        ip["bidirectional"] = props.get_bool("bidirectional")
    return ip


@register("integrator", "pssmlt")
def _pssmlt(props: Properties, ctx=None):
    ip = _mc_props(props)
    ip["p_large"] = props.get_float("pLarge", 0.3)
    ip["n_chains"] = props.get_int("chains", 8192)
    ip["burn_in"] = props.get_int("burnIn", 32)
    return _set(ctx, "pssmlt", _bidirectional(props, ip))


@register("integrator", "erpt")
def _erpt(props: Properties, ctx=None):
    ip = _mc_props(props)
    ip["chain_length"] = props.get_int("chainLength", 100)
    ip["chains_per_pixel"] = props.get_float("numChains", 1.0)
    return _set(ctx, "erpt", _bidirectional(props, ip))


@register("integrator", "mlt")
def _mlt(props: Properties, ctx=None):
    """Veach-style MLT with the lens, caustic, multi-chain, bidirectional
    and manifold mutations (``integrators/mlt.py``)."""
    ip = _mc_props(props)
    ip["p_large"] = props.get_float("pLarge", 0.1)
    ip["n_chains"] = props.get_int("chains", 8192)
    ip["burn_in"] = props.get_int("burnIn", 64)
    ip["p_lens"] = props.get_float("pLens", 0.35)
    ip["p_caustic"] = props.get_float("pCaustic", 0.2)
    ip["p_mchain"] = props.get_float("pMultiChain", 0.15)
    return _set(ctx, "mlt", ip)
