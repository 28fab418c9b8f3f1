"""Port vs reference: the wavefront path tracer ``path_li_v`` on the Cornell
box at 64^2 and depth 5, gated per pixel as ``parity_check.py`` gates the
TPU against the CPU (sum rel < 5e-3, p999 per-pixel rel < 1e-3, bad-pixel
fraction < 2e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import bridged, jax_cornell, npy, parity_gate, words

from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.core.types import Float
from mitsuba_im_tpu.integrators import path as jpath
from mitsuba_im_tpu.sensor.table import sample_ray_v as j_sample_ray_v
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.integrators import path as tpath
from mitsuba_im_tpu_torch.sensor.table import sample_ray_v as t_sample_ray_v

torch.set_num_threads(2)

W = H = 64
CASES = {
    "default": {},
    "skip_direct": dict(skip_direct=True),
    "roulette_hide_emitters": dict(rr_depth=2, hide_emitters=True),
}


def _jax_li(scene, cfg):
    n = W * H

    def run(scene):
        pix = jnp.arange(n, dtype=jnp.uint32)
        s = jrng.make_sampler_v(pix, jnp.uint32(7), jnp.uint32(0))
        s, blk = jrng.next_block4_v(s)
        uu = ((pix % W).astype(Float) + blk[0]) / W
        vv = ((pix // W).astype(Float) + blk[1]) / H
        o, d, _ = j_sample_ray_v(scene.sensor, uu, vv, blk[2], blk[3])
        li, s = jpath.path_li_v(scene, s, o, d, cfg)
        return li.x + li.y + li.z, s.dim

    return tuple(npy(a) for a in jax.jit(run)(scene))


def _torch_li(scene, cfg):
    n = W * H
    pix = torch.arange(n)
    s = trng.make_sampler_v(pix, 7, 0)
    s, blk = trng.next_block4_v(s)
    uu = ((pix % W).float() + blk[0]) / W
    vv = ((pix // W).float() + blk[1]) / H
    o, d, _ = t_sample_ray_v(scene.sensor, uu, vv, blk[2], blk[3])
    li, s = tpath.path_li_v(scene, s, o, d, cfg)
    return npy(li.x + li.y + li.z), s.dim


@pytest.mark.parametrize("case", list(CASES))
def test_path_li_v_parity_gate(case):
    jscene = jax_cornell()[0]
    kw = CASES[case]
    ref, ref_dim = _jax_li(jscene, jpath.PathConfig(max_depth=5, remat=False,
                                                    **kw))
    out, dim = _torch_li(bridged(jscene), tpath.PathConfig(max_depth=5, **kw))
    st = parity_gate(out, ref)
    assert st["ok"], st
    assert ref.sum() > 0
    np.testing.assert_array_equal(words(dim), words(ref_dim))


def test_mi_weight():
    rng = np.random.default_rng(30)
    a = rng.random(1000, dtype=np.float32)
    b = rng.random(1000, dtype=np.float32)
    a[:10] = 0.0
    b[:5] = 0.0
    np.testing.assert_allclose(
        npy(tpath.mi_weight(torch.from_numpy(a), torch.from_numpy(b))),
        npy(jpath.mi_weight(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)


def test_ray_differentials_raise():
    """Ray differentials, which raised before textures were ported (the
    name is kept), change nothing in a scene without MIP pyramids, as in
    the reference; the MCMC table mode of the sampler raises."""
    scene = bridged(jax_cornell()[0])
    assert not scene.textures.has_mip
    pix = torch.arange(64)
    o, d, _ = t_sample_ray_v(scene.sensor, *(torch.rand(64)
                                            for _ in range(4)))
    cfg = tpath.PathConfig(max_depth=3)
    li = [tpath.path_li_v(scene, trng.make_sampler_v(pix, 0, 0), o, d, cfg,
                          **kw)[0] for kw in ({}, dict(dddx=d, dddy=d))]
    for a, b in zip(*li):
        assert torch.equal(a, b)
    # the MCMC table mode, the one sampler mode left unported, raises
    s = trng.make_sampler_v(pix, 0, 0).replace(table=torch.zeros(64, 2, 4))
    with pytest.raises(NotImplementedError):
        tpath.path_li_v(scene, s, o, d, cfg)
