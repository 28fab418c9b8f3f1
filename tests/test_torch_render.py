"""Port vs reference: film splat/develop and ``render_film``; and the port's
independence from JAX (a subprocess with ``jax`` blocked imports every port
module and renders)."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import close, jax_cornell, npy, parity_gate

from mitsuba_im_tpu.film import film as jfilm
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu_torch.core.v3 import V3
from mitsuba_im_tpu_torch.film import film as tfilm
from mitsuba_im_tpu_torch.render import job as tjob
from mitsuba_im_tpu_torch.scenes import tiny_cornell

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_box_splat_and_develop():
    rng = np.random.default_rng(40)
    W, H, n = 13, 9, 3000
    pos = (rng.random((n, 2)) * [W, H]).astype(np.float32)
    pos[:4] = [[0, 0], [W - 1e-3, H - 1e-3], [5.5, 4.0], [12.99, 0.01]]
    val = rng.random((n, 3)).astype(np.float32)
    active = rng.random(n) < 0.9
    jf = jfilm.splat(jfilm.make_film(W, H, jfilm.F_BOX), jnp.asarray(pos),
                     jnp.asarray(val), jnp.asarray(active))
    tf = tfilm.splat(tfilm.make_film(W, H, tfilm.F_BOX, device="cpu"),
                     torch.from_numpy(pos[:, 0].copy()),
                     torch.from_numpy(pos[:, 1].copy()),
                     V3(*(torch.from_numpy(val[:, k].copy())
                          for k in range(3))),
                     torch.from_numpy(active))
    close(tf.data, jf.data)
    np.testing.assert_array_equal(npy(tf.data[..., 3]), npy(jf.data[..., 3]))
    close(tfilm.develop(tf), jfilm.develop(jf))


def test_render_film_parity_gate():
    """32^2, 2 spp, the Cornell settings (max_depth 4) through both
    packages' render_film."""
    jscene, jsettings = jax_cornell()
    ref = npy(jfilm.develop(jjob.render_film(jscene, jsettings, spp=2)))
    tscene, tsettings = tiny_cornell("cpu")
    film = tjob.render_film(tscene, tsettings, spp=2)
    out = npy(tfilm.develop(film))
    assert out.shape == ref.shape == (32, 32, 3)
    np.testing.assert_array_equal(npy(film.data[..., 3]), np.full((32, 32), 2.0))
    st = parity_gate(out.sum(-1).ravel(), ref.sum(-1).ravel())
    assert st["ok"], st


@pytest.mark.parametrize("field,value", [("integrator", "direct"),
                                         ("sampler", "ldsampler"),
                                         ("rfilter", tfilm.F_GAUSSIAN)])
def test_unported_render_options_raise(field, value):
    """An integrator the port lacks (``ptracer``) raises; the ``direct``
    integrator, the ldsampler and the Gaussian filter, which raised before
    they were ported (the names are kept), render the Cornell box as the
    reference does (16^2, 2 spp, under the gate)."""
    scene, settings = tiny_cornell("cpu")
    if field == "integrator":
        with pytest.raises(NotImplementedError):
            tjob.render_film(scene, dataclasses.replace(
                settings, integrator="ptracer"), spp=1)
    setattr(settings, field, value)
    settings.width = settings.height = 16
    jscene, jsettings = jax_cornell()
    jsettings = dataclasses.replace(jsettings, width=16, height=16,
                                    **{field: value})
    ref = npy(jfilm.develop(jjob.render_film(jscene, jsettings, spp=2)))
    out = npy(tfilm.develop(tjob.render_film(scene, settings, spp=2)))
    st = parity_gate(out.sum(-1).ravel(), ref.sum(-1).ravel())
    assert st["ok"], st


JAX_FREE = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None  # any import of jax now fails
    import torch
    torch.set_num_threads(2)
    import mitsuba_im_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke, bench_tri_kernels, bench_hier_kernels, bench_pass
    import profile_pass, tri_sass
    import mitsuba_im_tpu_torch.cli.main, mitsuba_im_tpu_torch.scene.xml
    from mitsuba_im_tpu_torch.core import registry
    registry._ensure_loaded()
    assert "path" in registry.available_plugins("integrator")
    leaked = [m for m in sys.modules
              if m == "mitsuba_im_tpu" or m.startswith("mitsuba_im_tpu.")]
    assert not leaked, leaked
    from mitsuba_im_tpu_torch.film.film import develop
    from mitsuba_im_tpu_torch.render.job import render_film
    from mitsuba_im_tpu_torch.scenes import tiny_cornell
    scene, settings = tiny_cornell("cpu")
    settings.width = settings.height = 16
    img = develop(render_film(scene, settings, spp=1))
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0
    print("imported", len(names), "modules")
""")


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", JAX_FREE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "imported" in r.stdout
