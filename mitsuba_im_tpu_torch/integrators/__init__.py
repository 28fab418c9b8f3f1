"""Integrator plugin factories (``mitsuba_im_tpu/integrators/__init__.py``).

``path`` records its name and parameters into the builder's render
settings, which ``render/job.py`` turns into a ``PathConfig``.  Every other
integrator the JAX package registers is registered here too and raises
``NotImplementedError`` naming its ROADMAP queue A item 7 entry when a
scene asks for it: nothing renders it with ``path`` instead.  The media,
the phase functions other than the two an ``hk`` layer reads
(``bsdf/__init__.py``), the volumes and the subsurface integrators belong
to those entries and raise the same way.
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


@register("integrator", "path")
def _path(props: Properties, ctx=None):
    ip = _mc_props(props)
    if ctx is not None:
        ctx.settings.integrator = "path"
        ctx.settings.integrator_props = ip
    return dict(name="path", **ip)


for _names, _item in (
        (("direct", "ao", "field", "motion"), "queue A item 7.1"),
        (("volpath", "volpath_simple"), "queue A item 7.2"),
        (("ptracer",), "queue A item 7.3"),
        (("bdpt",), "queue A item 7.4"),
        (("adaptive", "multichannel"), "queue A item 7.5"),
        (("photonmapper", "ppm", "sppm", "vpl", "irrcache"),
         "queue A item 7.6"),
        (("pssmlt", "mlt", "erpt"), "queue A item 7.8")):
    register_unported("integrator", _names, _item)

register_unported("medium", ("homogeneous", "heterogeneous"),
                  "queue A item 7.2")
register_unported("phase", ("rayleigh", "kkay", "microflake",
                            "mixturephase"), "queue A item 7.2")
register_unported("volume", ("constvolume", "gridvolume", "hgridvolume",
                             "volcache"), "queue A item 7.2")
register_unported("subsurface", ("dipole", "singlescatter"),
                  "queue A item 7.7")
