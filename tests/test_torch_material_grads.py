"""Port vs reference: scene gradients through the thirteen new BSDF
families and the environment map (``scenes.material_cornell`` at 16^2),
d sum(Li)/d refl, spec, alpha and the emitters' radiance, the port's
reverse mode (path replay) against the JAX package's, to 1e-4 of the
largest entry (test_torch_diff's GRAD_TOL).

The reference runs eagerly (``jax.disable_jit``): its compiled gradient
of a fourteen-type path takes over a minute to build on the CPU (its
forward-mode one nearly two), its eager one a fraction.  Two of its reverse-mode derivatives cannot be the
oracle (ROADMAP C6): ``jax.grad`` of ``bsdf.spec`` is NaN on the CPU (the
loop's transpose meets masked lanes' infinities), so spec is taken in
forward mode (``jax.jacfwd``), as alpha always is; and the CPU
brute-force branch differentiates the triangle ``t`` that the port (as
the accelerated branches) detaches, which moves ``bsdf.alpha``'s
derivative wherever a bounce's hit point matters (the area light's MIS
pdf).  So alpha and spec are held on the icosahedra under the sky alone
at depth 2, where light arrives from directions only; refl and both
emitters' radiance on material_cornell itself at depth 3.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_diff import jax_sum_li, rel_err, torch_grads
from test_torch_helpers import bridged, npy

from mitsuba_im_tpu.core.transform import Transform as JTransform
from mitsuba_im_tpu.diff import optimize as jopt
from mitsuba_im_tpu.integrators import path as jpath
from mitsuba_im_tpu.scene.build import SceneBuilder as JBuilder
from mitsuba_im_tpu.sensor.table import make_sensor as jmake_sensor
from mitsuba_im_tpu.sensor.table import S_PERSPECTIVE as JS_PERSPECTIVE
from mitsuba_im_tpu_torch import scenes
from mitsuba_im_tpu_torch.bsdf import common as bc
from mitsuba_im_tpu_torch.emitter import hosek
from mitsuba_im_tpu_torch.integrators import path as tpath

torch.set_num_threads(2)

GRAD_TOL = 1e-4
W = 16
# the families whose alpha column moves the image (HK's is its g)
ROUGH = (bc.ROUGHDIFFUSE, bc.ROUGHDIELECTRIC, bc.ROUGHPLASTIC, bc.WARD,
         bc.HK)


def _jax_scene(box: bool):
    """The material_cornell content (``box``) or its icosahedra under the
    sky alone (a closer camera), built by the JAX package."""
    b = JBuilder()
    c = scenes.CORNELL_CAMERA
    if box:
        scenes.fill_material_cornell(b)
        look = (c["origin"], c["target"], c["up"])
    else:
        scenes.add_material_icosahedra(b)
        b.add_emitter(hosek.sky_record(scenes.SUN_DIR, resolution=64))
        look = ([0, 0.6, 2.6], [0, 0.6, 0], [0, 1, 0])
    b.sensor = jmake_sensor(JS_PERSPECTIVE, JTransform.look_at(*look),
                            fov_deg=c["fov_deg"])
    return b.build()[0]


def _reference(jscene, depth, labels):
    """The reference's gradient by ``jax.grad``, eagerly."""
    f = jax_sum_li(jscene, jpath.PathConfig(remat=False, max_depth=depth), W)
    with jax.disable_jit():
        g = jax.grad(f)(jopt.get_params(jscene, labels))
    return {k: np.asarray(v) for k, v in g.items()}


def _port_grads(jscene, depth, labels):
    """The port's gradients of the bridged scene; its backward returns no
    NaN anywhere (anomaly mode: a masked lane turns no zero cotangent into
    one)."""
    with torch.autograd.detect_anomaly():
        got = torch_grads(bridged(jscene), tpath.PathConfig(max_depth=depth),
                          W, labels)
    return {k: npy(g) for k, g in got.items()}


@pytest.mark.filterwarnings("ignore:Anomaly Detection has been enabled")
def test_refl_radiance_match_reference():
    """material_cornell at depth 3: d/d refl and d/d the radiance of both
    emitters (the area light and the sky's scale, each carrying light)
    against ``jax.grad``, entry by entry."""
    labels = ("bsdf.refl", "emitter.radiance")
    jscene = _jax_scene(True)
    ref = _reference(jscene, 3, labels)
    got = _port_grads(jscene, 3, labels)
    for k in labels:
        assert np.isfinite(got[k]).all() and np.abs(ref[k]).max() > 0, k
        assert rel_err(got[k], ref[k]) < GRAD_TOL, (k, rel_err(got[k],
                                                                ref[k]))
    assert (np.abs(got["emitter.radiance"]).sum(1) > 0).all()


@pytest.mark.filterwarnings("ignore:Anomaly Detection has been enabled")
def test_alpha_spec_match_forward_mode():
    """The icosahedra under the sky at depth 2: d/d alpha and d/d spec in
    forward mode.  ``jax.jacfwd`` would take one tangent per entry (65 here,
    over a minute eagerly); its columns are forward derivatives along the
    basis, so the port's gradient is held to ``jax.jvp`` along two
    directions v of both tables at once whose entries are ±1 / |g_i| (±1
    where g_i is 0), so that every entry of every family weighs the same:
    |g . v - jvp(v)| within GRAD_TOL of sum |g_i v_i|, a sum of ones (29
    here), so an error of 0.3% in any one entry of any family fails.  Both
    tables, and each rough family's alpha row, are non-zero."""
    labels = ("bsdf.alpha", "bsdf.spec")
    jscene = _jax_scene(False)
    got = _port_grads(jscene, 2, labels)
    params = jopt.get_params(jscene, labels)
    f = jax_sum_li(jscene, jpath.PathConfig(remat=False, max_depth=2), W)
    rng = np.random.default_rng(91)
    for _ in range(2):
        v = {}
        for k in labels:
            g = np.abs(got[k])
            sign = rng.choice([-1.0, 1.0], size=g.shape)
            v[k] = np.where(g > 0, sign / np.where(g > 0, g, 1.0),
                            sign).astype(np.float32)
        with jax.disable_jit():
            _, jvp = jax.jvp(f, (params,),
                             ({k: jax.numpy.asarray(a) for k, a in v.items()},))
        terms = np.concatenate([(got[k] * v[k]).ravel() for k in labels])
        assert np.isfinite(terms).all()
        assert abs(terms.sum() - float(jvp)) < GRAD_TOL * np.abs(terms).sum()
    rough = [b for b, t in enumerate(np.asarray(jscene.bsdfs.type))
             if t in ROUGH]
    assert len(rough) == len(ROUGH)
    assert all(np.abs(got[k]).max() > 0 for k in labels)
    assert all(np.abs(got["bsdf.alpha"][b]).max() > 0 for b in rough)
