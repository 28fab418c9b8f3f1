"""Bridge from the JAX package's scene to the port's :class:`Scene`.

:func:`export_tables` reads a built ``mitsuba_im_tpu`` scene by attribute
and returns the tables the port uses as numpy arrays (keyed
``"<table>.<leaf>"``) plus static Python values; :func:`scene_from_numpy`
turns those into the port's Scene on a device.  Together they feed both
packages the same scene bit for bit: the cluster hierarchy of large scenes
(a motion hierarchy's frame-1 rows ``clusters.blocks1`` and its shutter
time ``clusters.time`` too, and an instanced one's indirect tables), the
instances' normal rotations (``geom.inst_rot``), the frame-1 mirror of a
deformable scene (``motion.*``) and the IRAWAN weave patterns
(``bsdfs.weaves``, the reference's ``WeavePattern`` records field by field,
its normalization included) and the participating media (``media.*``,
with the shapes' medium columns and the camera's medium) and the
subsurface table (``subsurface.*``: the records' coefficients, the points,
their irradiance and the hash grid, with its statics), which arrives bit
for bit, the grid's order and buckets as the port's int64 words.  Neither
imports jax: ``np.asarray`` reads the reference's arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import entry_device, host_tensor
from ..accel import hierarchy as hy
from ..bsdf import common as bc
from ..bsdf.irawan import WeavePattern
from ..emitter import table as em
from ..media import medium as med
from ..sensor.table import SENSOR_LEAVES, Sensor
from .. import subsurface as ss
from ..texture import texture as tx
from .geometry import GEOMETRY_LEAVES, Geometry
from .scene import Scene

SCENE_LEAVES = ("shape_bsdf", "shape_emitter", "shape_interior",
                "shape_exterior", "shape_subsurface")
_EMITTER_SRC = {"select_pmf": ("select", "pmf"),
                "select_cdf": ("select", "cdf"),
                **{"env_" + k: ("env_dist", k) for k in em.ENV_DIST_LEAVES}}


def _np(x) -> np.ndarray:
    """A leaf of either package's scene as numpy (a port tensor is copied
    to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _reference_emitter_leaf(emitters, k: str):
    """The reference's emitter table keeps its selection and environment
    distributions in sub-records (``_EMITTER_SRC``)."""
    for attr in _EMITTER_SRC.get(k, (k,)):
        emitters = getattr(emitters, attr)
    return emitters


def export_tables(src, emitter_leaf=_reference_emitter_leaf
                  ) -> tuple[dict, dict]:
    """(arrays, statics) of a ``mitsuba_im_tpu`` Scene (:func:`export_scene`
    exports the port's own)."""
    arrays = {}
    for k in GEOMETRY_LEAVES:
        arrays[f"geom.{k}"] = _np(getattr(src.geom, k))
    for k in bc.BSDF_LEAVES:
        arrays[f"bsdfs.{k}"] = _np(getattr(src.bsdfs, k))
    for k in tx.TEXTURE_LEAVES:
        arrays[f"textures.{k}"] = _np(getattr(src.textures, k))
    for k in em.EMITTER_LEAVES:
        arrays[f"emitters.{k}"] = _np(emitter_leaf(src.emitters, k))
    for k in SENSOR_LEAVES:
        arrays[f"sensor.{k}"] = _np(getattr(src.sensor, k))
    for k in SCENE_LEAVES:
        arrays[f"scene.{k}"] = _np(getattr(src, k))
    arrays["bsdfs.weave_id"] = _np(src.bsdfs.weave_id)
    for k in med.MEDIUM_LEAVES:
        arrays[f"media.{k}"] = _np(getattr(src.media, k))
    h = src.clusters
    if h is not None:
        for k in hy.HIERARCHY_LEAVES:
            arrays[f"clusters.{k}"] = _np(getattr(h, k))
        if h.has_motion:
            arrays["clusters.blocks1"] = _np(h.blocks1)
    if src.motion is not None:
        for k, a in src.motion.items():
            arrays[f"motion.{k}"] = _np(a)
    sub = src.subsurface
    if sub is not None:
        for k in ss.SUBSURFACE_LEAVES:
            arrays[f"subsurface.{k}"] = _np(getattr(sub, k))
    g, b, e = src.geom, src.bsdfs, src.emitters
    statics = {
        "geom.n_tris": g.n_tris, "geom.n_spheres": g.n_spheres,
        "geom.n_disks": g.n_disks, "geom.instanced": g.instanced,
        "bsdfs.used_types": tuple(b.used_types),
        "bsdfs.unwrap_depth": b.unwrap_depth, "bsdfs.has_bump": b.has_bump,
        "bsdfs.weaves": tuple(dataclasses.asdict(w) for w in b.weaves),
        "emitters.n_emitters": e.n_emitters,
        "emitters.used_types": tuple(e.used_types),
        "emitters.used_area_kinds": tuple(e.used_area_kinds),
        "emitters.env_index": e.env_index,
        "sensor.type": src.sensor.type,
        "textures.used_types": tuple(src.textures.used_types),
        "textures.has_mip": src.textures.has_mip,
        "scene.subsurface": src.subsurface is not None,
        "scene.motion": src.motion is not None,
        "scene.clusters": h is not None,
        "scene.camera_medium": int(src.camera_medium),
        **{f"media.{k}": getattr(src.media, k)
           for k in ("n_media", "used_phase", "has_hetero",
                     "has_fancy_phase")},
    }
    if sub is not None:
        statics.update({f"subsurface.{k}": getattr(sub, k)
                        for k in ss.SUBSURFACE_STATICS})
    if h is not None:
        statics.update({"clusters.n_supers": h.n_supers,
                        "clusters.n_tris": h.n_tris,
                        "clusters.indirect": h.indirect,
                        "clusters.has_motion": h.has_motion,
                        "clusters.time": (float(np.asarray(h.time))
                                          if h.has_motion else 0.0)})
    return arrays, statics


def export_scene(scene: Scene) -> tuple[dict, dict]:
    """(arrays, statics) of the port's own Scene, its tensors copied to the
    host (``parallel/remote.py`` ships a scene to a render node so)."""
    return export_tables(scene, emitter_leaf=getattr)


def _sub(arrays: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: a for k, a in arrays.items() if k.startswith(prefix + ".")}


def scene_from_numpy(arrays: dict, statics: dict, device="cuda") -> Scene:
    """The port's Scene from exported tables, on ``device`` (the card unless
    the CPU is asked for)."""
    device = entry_device(device)

    ga = _sub(arrays, "geom")
    geom = Geometry(
        **{k: host_tensor(ga[k], np.int32 if k.endswith("_shape")
                          else np.float32, device) for k in GEOMETRY_LEAVES},
        n_tris=statics["geom.n_tris"], n_spheres=statics["geom.n_spheres"],
        n_disks=statics["geom.n_disks"],
        instanced=bool(statics.get("geom.instanced", False)))
    ta = _sub(arrays, "textures")
    bsdfs = bc.table_from_arrays(
        _sub(arrays, "bsdfs"), statics["bsdfs.used_types"],
        statics["bsdfs.unwrap_depth"], device, ta,
        weaves=tuple(WeavePattern.from_dict(w)
                     for w in statics.get("bsdfs.weaves", ())))
    textures = tx.table_from_arrays(
        ta, statics["textures.used_types"], statics["textures.has_mip"],
        device)
    emitters = em.table_from_arrays(
        _sub(arrays, "emitters"), statics["emitters.n_emitters"],
        statics["emitters.used_types"], statics["emitters.used_area_kinds"],
        statics["emitters.env_index"], device)
    clusters = None
    if statics["scene.clusters"]:
        clusters = hy.hierarchy_from_arrays(
            _sub(arrays, "clusters"), statics["clusters.n_supers"],
            statics["clusters.n_tris"], statics["clusters.indirect"], device,
            statics.get("clusters.has_motion", False),
            statics.get("clusters.time", 0.0))
    motion = None
    if statics.get("scene.motion"):
        motion = {k: host_tensor(a, np.float32, device)
                  for k, a in _sub(arrays, "motion").items()}
    sa = _sub(arrays, "sensor")
    sensor = Sensor(**{k: host_tensor(sa[k], np.float32, device)
                       for k in SENSOR_LEAVES}, type=statics["sensor.type"])
    media = med.table_from_arrays(
        _sub(arrays, "media"),
        {k[len("media."):]: x for k, x in statics.items()
         if k.startswith("media.")}, device)
    subsurface = None
    if statics.get("scene.subsurface"):
        subsurface = ss.table_from_arrays(
            _sub(arrays, "subsurface"),
            {k: statics[f"subsurface.{k}"] for k in ss.SUBSURFACE_STATICS},
            device)
    sc = _sub(arrays, "scene")
    return Scene(geom=geom, bsdfs=bsdfs, textures=textures,
                 emitters=emitters, sensor=sensor, media=media,
                 camera_medium=int(statics["scene.camera_medium"]),
                 clusters=clusters, motion=motion, subsurface=subsurface,
                 shutter=tuple(float(np.float32(sa[k])) for k in
                               ("shutter_open", "shutter_time")),
                 **{k: host_tensor(sc[k], np.int32, device)
                    for k in SCENE_LEAVES})
