"""Port vs reference: the direct, ao, field and motion integrators
(``mitsuba_im_tpu_torch/integrators/simple.py``), the sensor's film
projection (``sensor/table.py::connect_v``), their factories and the
render loop's integrator dispatch (``render/job.py::integrator_fn``).

The Cornell box of ``tests/test_render.py`` is loaded by both packages;
each integrator runs on the same camera rays and the same per-lane
sampler state (the reference's ``next_block4`` and the port's
``next_block4_v`` draw the same words, checked here), and its radiance is
held to the reference's under parity_check.py's image gate (direct, ao)
or to rel 1e-5 (the field quantities and the motion vectors; shape and
primitive indices exactly).  ``direct`` and ``ao`` also render from a
scene file through the port's command line at 16^2 against the
reference's ``render_film`` under the gate.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import close, npy, parity_gate, tv3
from test_render import CORNELL_XML

from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.film.film import develop as jdevelop
from mitsuba_im_tpu.integrators import simple as jsimple
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu.scene.xml import load_scene as jload
from mitsuba_im_tpu.sensor import table as jsensor
from mitsuba_im_tpu_torch.cli.main import main
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.integrators import simple as tsimple
from mitsuba_im_tpu_torch.io.exr import read_exr
from mitsuba_im_tpu_torch.render import job as tjob
from mitsuba_im_tpu_torch.scene.xml import load_scene as tload
from mitsuba_im_tpu_torch.sensor.table import connect_v, sample_ray_v

torch.set_num_threads(2)

RES = 24
INTEGRATORS = {
    "direct": '<integrator type="direct"><integer name="emitterSamples" '
              'value="2"/><integer name="bsdfSamples" value="2"/>'
              '</integrator>',
    "ao": '<integrator type="ao"><integer name="shadingSamples" value="4"/>'
          '</integrator>',
    "motion": '<integrator type="motion"/>',
}
FIELD = ('<integrator type="field"><string name="field" value="{}"/>'
         '</integrator>')


def _xml(integrator, res=RES, spp=2):
    xml = CORNELL_XML.format(max_depth=3, spp=spp, res=res)
    start = xml.index("<integrator")
    end = xml.index("</integrator>") + len("</integrator>")
    return xml[:start] + integrator + xml[end:]


def _scenes(tmp_path, integrator):
    path = str(tmp_path / "scene.xml")
    with open(path, "w") as f:
        f.write(_xml(integrator))
    jscene, jset = jload(path)
    tscene, tset = tload(path, device="cpu")
    return path, (jscene, jset), (tscene, tset)


def _rays_and_samplers(tscene):
    """Camera rays of the pixel centres and both packages' samplers of
    pass 0 after the camera block."""
    n = RES * RES
    pix = np.arange(n)
    u = ((pix % RES) + 0.5).astype(np.float32) / RES
    v = ((pix // RES) + 0.5).astype(np.float32) / RES
    z = torch.zeros(n)
    o, d, _ = sample_ray_v(tscene.sensor, torch.from_numpy(u),
                           torch.from_numpy(v), z, z)
    o = np.stack([npy(c) for c in o], 1)
    d = np.stack([npy(c) for c in d], 1)
    js, jb = jrng.next_block4(jrng.make_sampler(jnp.asarray(pix), 0, 3))
    ts, tb = trng.next_block4_v(trng.make_sampler_v(torch.from_numpy(pix),
                                                    0, 3))
    for k in range(4):
        np.testing.assert_array_equal(npy(tb[k]), npy(jb[..., k]))
    return o, d, js, ts


def _both(tmp_path, integrator, jfn, tfn):
    _, (jscene, _), (tscene, tset) = _scenes(tmp_path, integrator)
    o, d, js, ts = _rays_and_samplers(tscene)
    jli, js2 = jfn(jscene, js, jnp.asarray(o), jnp.asarray(d))
    tli, ts2 = tfn(tscene, ts, tv3(o), tv3(d), tset)
    # the same words drawn after the integrator's blocks
    jn = jrng.next_block4(js2)[1]
    tn = trng.next_block4_v(ts2)[1]
    for k in range(4):
        np.testing.assert_array_equal(npy(tn[k]), npy(jn[..., k]))
    return (np.stack([npy(c) for c in tli], 1).reshape(RES, RES, 3),
            npy(jli).reshape(RES, RES, 3))


@pytest.mark.parametrize("case", ["direct", "ao"])
def test_shading_integrators_match_reference(case, tmp_path):
    if case == "direct":
        jfn = lambda s, sm, o, d: jsimple.direct_li(  # noqa: E731
            s, sm, o, d, emitter_samples=2, bsdf_samples=2)
    else:
        jfn = lambda s, sm, o, d: jsimple.ao_li(  # noqa: E731
            s, sm, o, d, shading_samples=4)
    port, ref = _both(tmp_path, INTEGRATORS[case], jfn,
                      lambda s, sm, o, d, st: tjob.integrator_fn(st)(
                          s, sm, o, d))
    st = parity_gate(port, ref)
    assert st["ok"], st
    assert ref.mean() > 0.05


@pytest.mark.parametrize("field", tsimple.FIELDS)
def test_field_matches_reference(field, tmp_path):
    port, ref = _both(
        tmp_path, FIELD.format(field),
        lambda s, sm, o, d: jsimple.field_li(s, sm, o, d, field),
        lambda s, sm, o, d, st: tjob.integrator_fn(st)(s, sm, o, d))
    if field in ("shapeIndex", "primIndex"):
        np.testing.assert_array_equal(port, ref)
    else:
        close(port, ref, atol=1e-5)
    assert np.abs(ref).max() > 0


def test_motion_and_connect_match_reference(tmp_path):
    """No previous pose from a scene file: (0, 0, distance) (ROADMAP C13);
    with one, the reprojected film offset; connect's every output."""
    port, ref = _both(
        tmp_path, INTEGRATORS["motion"],
        lambda s, sm, o, d: jsimple.motion_li(s, sm, o, d, width=RES,
                                              height=RES),
        lambda s, sm, o, d, st: tjob.integrator_fn(st)(s, sm, o, d))
    close(port, ref)
    assert (port[..., :2] == 0).all() and port[..., 2].max() > 1.0
    _, (jscene, _), (tscene, _) = _scenes(tmp_path, INTEGRATORS["motion"])
    rng = np.random.default_rng(5)
    p = rng.uniform(-1.5, 2.5, (2000, 3)).astype(np.float32)
    ju = jsensor.connect(jscene.sensor, jnp.asarray(p))
    tu = connect_v(tscene.sensor, tv3(p))
    np.testing.assert_array_equal(npy(tu[5]), npy(ju[4]))
    ok = npy(ju[4])
    assert ok.any() and not ok.all()
    close(npy(tu[0])[ok], npy(ju[0])[ok, 0])
    close(npy(tu[1])[ok], npy(ju[0])[ok, 1])
    close(npy(tu[3]), npy(ju[2]))
    close(npy(tu[4])[ok], npy(ju[3])[ok])
    prev = np.eye(4, dtype=np.float32)
    prev[:3, :] = npy(tscene.sensor.to_world)[:3, :]
    prev[0, 3] += 0.1
    o, d, js, ts = _rays_and_samplers(tscene)
    jli, _ = jsimple.motion_li(jscene, js, jnp.asarray(o), jnp.asarray(d),
                               prev_to_world=prev, width=RES, height=RES)
    tli, _ = tsimple.motion_li_v(tscene, ts, tv3(o), tv3(d),
                                 prev_to_world=prev, width=RES, height=RES)
    tli = np.stack([npy(c) for c in tli], 1)
    close(tli, npy(jli), atol=1e-4)
    assert np.abs(tli[:, 0]).max() > 0.1


@pytest.mark.parametrize("case", ["direct", "ao"])
def test_cli_render_matches_reference(case, tmp_path):
    """The scene file through the command line at 16^2 against the
    reference's ``render_film``."""
    path = str(tmp_path / "scene.xml")
    with open(path, "w") as f:
        f.write(_xml(INTEGRATORS[case], res=16, spp=2))
    out = str(tmp_path / "out.exr")
    assert main([path, "-o", out, "-q", "--device", "cpu"]) == 0
    img, _ = read_exr(out)
    scene, settings = jload(path)
    ref = np.asarray(jdevelop(jjob.render_film(scene, settings)))
    st = parity_gate(img, ref.astype(np.float16).astype(np.float32))
    assert st["ok"], st
    _, tset = tload(path, device="cpu")
    assert tset.integrator == settings.integrator == case
    assert tset.integrator_props == settings.integrator_props


def test_unknown_field_raises(tmp_path):
    _, _, (tscene, tset) = _scenes(tmp_path, FIELD.format("curvature"))
    o, d, _, ts = _rays_and_samplers(tscene)
    with pytest.raises(ValueError, match="unknown field"):
        tjob.integrator_fn(tset)(tscene, ts, tv3(o), tv3(d))
