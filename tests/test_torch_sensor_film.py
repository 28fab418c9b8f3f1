"""Port vs reference: every sensor type (``sensor/table.py``, the factories
of ``sensor/__init__.py``), the primary rays' differentials on each
(``render/raydiff.py``), every reconstruction filter and the filtered
splat (``film/film.py``), the film and filter factories
(``film/__init__.py``) and the render defaults.

Rays and filter weights agree to rel 1e-5 / abs 1e-6; the spherical and
irradiance meter's directions go through sin and cos of the film position
(the latter through the concentric disk), whose last bits differ between
XLA and PyTorch: abs 4e-6 there, as for the environment map's directions
(test_torch_envmap.py).  Host tables (the sensors' leaves, the factories'
records and settings) are bit for bit.
The filtered films agree to float32 tolerance: both accumulate the same
terms, the port in one ``index_add_`` and the reference tap by tap.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import close, close_v3, jax_cornell, npy

from mitsuba_im_tpu.core.properties import Properties
from mitsuba_im_tpu.core.registry import create
from mitsuba_im_tpu.core.transform import Transform as JTransform
from mitsuba_im_tpu.film import film as jfilm
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu.render import raydiff as jraydiff
from mitsuba_im_tpu.scene.build import RenderSettings as JSettings
from mitsuba_im_tpu.scene.build import SceneBuilder as JBuilder
from mitsuba_im_tpu.sensor import table as jsensor
from mitsuba_im_tpu_torch import film as tfilmf
from mitsuba_im_tpu_torch import sensor as tsensorf
from mitsuba_im_tpu_torch.core.transform import Transform as TTransform
from mitsuba_im_tpu_torch.core.v3 import V3
from mitsuba_im_tpu_torch.film import film as tfilm
from mitsuba_im_tpu_torch.render import job as tjob
from mitsuba_im_tpu_torch.render import raydiff as traydiff
from mitsuba_im_tpu_torch.scenes import tiny_cornell
from mitsuba_im_tpu_torch.sensor import table as tsensor

torch.set_num_threads(2)

LOOK = ([0.3, 1.1, 3.9], [0.0, 0.9, 0.0], [0, 1, 0])
SENSORS = {
    "perspective": (tsensor.S_PERSPECTIVE, {}),
    "thinlens": (tsensor.S_THINLENS, dict(aperture_radius=0.1,
                                          focus_distance=3.9)),
    "orthographic": (tsensor.S_ORTHOGRAPHIC, dict(scale_x=1.2, scale_y=0.8)),
    "telecentric": (tsensor.S_TELECENTRIC, dict(
        scale_x=1.2, scale_y=0.8, aperture_radius=0.1, focus_distance=2.0)),
    "spherical": (tsensor.S_SPHERICAL, {}),
    "radiancemeter": (tsensor.S_RADIANCEMETER, {}),
    "irradiancemeter": (tsensor.S_IRRADIANCEMETER, {}),
}


def _uniforms(rng, n):
    u = rng.random((4, n), dtype=np.float32)
    u[:, :4] = [[0.0, 0.5, 1 - 2**-24, 0.25], [0.0, 0.5, 1 - 2**-24, 0.75],
                [0.5, 0.0, 0.3, 1 - 2**-24], [0.5, 0.0, 0.7, 0.5]]
    return u


@pytest.mark.parametrize("name", list(SENSORS))
def test_sample_ray_and_differentials(name):
    stype, kw = SENSORS[name]
    js = jsensor.make_sensor(stype, JTransform.look_at(*LOOK), fov_deg=39.3,
                             aspect=1.25, **kw)
    ts = tsensor.make_sensor(stype, TTransform.look_at(*LOOK), fov_deg=39.3,
                             aspect=1.25, **kw, device="cpu")
    assert ts.type == js.type
    for k in tsensor.SENSOR_LEAVES:
        np.testing.assert_array_equal(npy(getattr(ts, k)),
                                      npy(getattr(js, k)), err_msg=k)
    u = _uniforms(np.random.default_rng(70), 4096)
    ju = [jnp.asarray(a) for a in u]
    tu = [torch.from_numpy(a) for a in u]
    atol = 4e-6 if stype in (tsensor.S_SPHERICAL,
                             tsensor.S_IRRADIANCEMETER) else 1e-6
    jo, jd, jw = jsensor.sample_ray_v(js, *ju)
    to, td, tw = tsensor.sample_ray_v(ts, *tu)
    close_v3(to, jo)
    close_v3(td, jd, atol=atol)
    close(tw, jw)
    for a, b in zip(traydiff.camera_ray_differentials(ts, *tu, 1 / 40,
                                                      1 / 32),
                    jraydiff.camera_ray_differentials(js, *ju, 1 / 40,
                                                      1 / 32)):
        close_v3(a, b, atol=atol)


def _xf(cls, scale=None):
    xf = cls.look_at(*LOOK)
    return xf @ cls.scale(scale) if scale is not None else xf


# (plugin, reference properties, port keywords)
SENSOR_FACTORIES = [
    ("perspective", dict(fov=50.0, fovAxis="y"),
     dict(fov=50.0, fov_axis="y")),
    ("perspective", dict(focalLength="35mm"), dict(focal_length="35mm")),
    ("perspective_rdist", dict(kc="0.1, 0"), dict(kc="0.1, 0")),
    ("thinlens", dict(fov=30.0, apertureRadius=0.05, focusDistance=3.0),
     dict(fov=30.0, aperture_radius=0.05, focus_distance=3.0)),
    ("orthographic", {}, {}),
    ("telecentric", dict(apertureRadius=0.02, focusDistance=2.0),
     dict(aperture_radius=0.02, focus_distance=2.0)),
    ("spherical", {}, {}),
    ("radiancemeter", {}, {}),
    ("irradiancemeter", {}, {}),
    ("fluencemeter", {}, {}),
]


@pytest.mark.parametrize("case", range(len(SENSOR_FACTORIES)),
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(SENSOR_FACTORIES)])
def test_sensor_factories(case):
    """Each plugin's sensor (the crop aspect from the settings, clip
    planes and shutter from the properties) bit for bit."""
    name, props_kw, port_kw = SENSOR_FACTORIES[case]
    scale = [1.5, 0.75, 1.0] if name in ("orthographic",
                                         "telecentric") else None
    props = Properties(name)
    for k, val in dict(props_kw, toWorld=_xf(JTransform, scale), nearClip=0.1,
                       farClip=100.0, shutterOpen=0.2,
                       shutterClose=0.7).items():
        props.set(k, val)
    jb = JBuilder()
    jb.settings.width, jb.settings.height = 40, 32
    ref = create("sensor", props, jb)
    out = getattr(tsensorf, name)(
        to_world=_xf(TTransform, scale), near_clip=0.1, far_clip=100.0,
        shutter_open=0.2, shutter_close=0.7,
        settings=tjob.RenderSettings(width=40, height=32), **port_kw)
    assert out.type == ref.type
    for k in tsensor.SENSOR_LEAVES:
        np.testing.assert_array_equal(npy(getattr(out, k)),
                                      npy(getattr(ref, k)), err_msg=k)


@pytest.mark.parametrize("name", list(jfilm.FILTER_NAMES))
def test_filter_eval_and_splat(name):
    """filter_eval over its support and past it, and the splat of seeded
    samples (some masked off, some at the image's edges) into a 16^2
    film, against the reference's."""
    ftype = tfilm.FILTER_NAMES[name]
    r = tfilm.DEFAULT_RADIUS[ftype]
    assert tfilm.FILTER_NAMES == jfilm.FILTER_NAMES
    assert tfilm.DEFAULT_RADIUS == jfilm.DEFAULT_RADIUS
    x = np.concatenate([np.linspace(-r - 0.5, r + 0.5, 4001),
                        [0.0, 1e-7, -1e-7, r, -r]]).astype(np.float32)
    close(tfilm.filter_eval(ftype, torch.from_numpy(x), r),
          jfilm.filter_eval(ftype, jnp.asarray(x), r))

    rng = np.random.default_rng(71)
    W = H = 16
    n = 3000
    pos = (rng.random((n, 2)) * [W, H]).astype(np.float32)
    pos[:4] = [[0, 0], [W - 1e-3, H - 1e-3], [5.5, 4.0], [15.99, 0.01]]
    val = rng.random((n, 3)).astype(np.float32)
    active = rng.random(n) < 0.9
    jf = jfilm.splat(jfilm.make_film(W, H, ftype), jnp.asarray(pos),
                     jnp.asarray(val), jnp.asarray(active))
    tf = tfilm.splat(tfilm.make_film(W, H, ftype, device="cpu"),
                     torch.from_numpy(pos[:, 0].copy()),
                     torch.from_numpy(pos[:, 1].copy()),
                     V3(*(torch.from_numpy(val[:, k].copy())
                          for k in range(3))),
                     torch.from_numpy(active))
    assert (tf.ftype, tf.radius) == (jf.ftype, jf.radius)
    close(tf.data, jf.data, atol=1e-5)
    close(tfilm.develop(tf), jfilm.develop(jf), atol=1e-5)


def test_render_defaults_and_merge():
    """The repaired defaults: ``RenderSettings().rfilter`` and
    ``make_film`` are the reference's (the Gaussian of radius 2), and
    ``render_film(scene, RenderSettings())`` filters with it; ``merge``
    sums films."""
    assert tjob.RenderSettings().rfilter == JSettings().rfilter \
        == tfilm.F_GAUSSIAN
    assert tjob.RenderSettings().rfilter_radius is JSettings().rfilter_radius
    tf, jf = tfilm.make_film(8, 6, device="cpu"), jfilm.make_film(8, 6)
    assert (tf.width, tf.height, tf.ftype, tf.radius) == (
        jf.width, jf.height, jf.ftype, jf.radius) == (8, 6, 2, 2.0)
    scene, _ = tiny_cornell("cpu")
    kw = dict(width=8, height=8, spp=1, integrator_props=dict(max_depth=2))
    film = tjob.render_film(scene, tjob.RenderSettings(**kw))
    ref = jjob.render_film(jax_cornell()[0], JSettings(**kw))
    assert (film.ftype, film.radius) == (ref.ftype, ref.radius) == (
        tfilm.F_GAUSSIAN, 2.0)
    # each sample spread over 16 pixels with the reference's weights
    assert not bool((film.data[..., 3] == 1.0).all())
    close(film.data, ref.data, atol=1e-5)

    rng = np.random.default_rng(72)
    parts = [rng.random((6, 8, 4)).astype(np.float32) for _ in range(3)]
    out = tfilm.merge([dataclasses.replace(tf, data=torch.from_numpy(p))
                       for p in parts])
    ref = jfilm.merge([jf.replace(data=jnp.asarray(p)) for p in parts])
    np.testing.assert_array_equal(npy(out.data), npy(ref.data))


@pytest.mark.parametrize("name", ["hdrfilm", "ldrfilm"])
def test_film_and_filter_factories(name):
    """Every rfilter plugin's record, and the film plugins' settings with
    and without an rfilter child."""
    for fname, props_kw, port_kw in (
            ("box", {}, {}), ("tent", {}, {}),
            ("gaussian", dict(stddev=0.3), dict(stddev=0.3)),
            ("mitchell", {}, {}), ("catmullrom", {}, {}),
            ("lanczos", dict(lobes=2), dict(lobes=2))):
        props = Properties(fname)
        for k, val in props_kw.items():
            props.set(k, val)
        ref = create("rfilter", props)
        assert tfilmf.RFILTERS[fname](**port_kw) == ref, fname
        assert tfilmf.RFILTERS[fname]() == create("rfilter",
                                                  Properties(fname))
    for child in (None, "lanczos"):
        props = Properties(name)
        props.set("width", 40)
        props.set("height", 24)
        rec = None
        if child:
            rec = tfilmf.RFILTERS[child]()
            props.children["rfilter"] = create("rfilter", Properties(child))
        jb = JBuilder()
        create("film", props, jb)
        settings = tjob.RenderSettings()
        getattr(tfilmf, name)(settings, 40, 24, rfilter=rec)
        for k in ("width", "height", "rfilter", "rfilter_radius"):
            assert getattr(settings, k) == getattr(jb.settings, k), k
