"""Port vs reference: RNG words (bit for bit), V3 frames and warps, primary
rays (``mitsuba_im_tpu_torch/core``, ``sensor``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (bridged, close, close_v3, jax_cornell, jv3,
                                npy, tv3, unit_vectors, words)

from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.core import v3 as jv
from mitsuba_im_tpu.sensor import table as jsensor
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.core import v3 as tv
from mitsuba_im_tpu_torch.sensor import table as tsensor

torch.set_num_threads(2)


def test_pcg4d_words_bit_exact():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2**32, size=(4, 4096), dtype=np.uint64)
    w[:, :4] = [[0] * 4, [0xFFFFFFFF] * 4, [1, 2, 3, 4], [2**31] * 4]
    ref = jrng.pcg4d_words(*(jnp.asarray(a.astype(np.uint32)) for a in w))
    out = trng.pcg4d_words(*(torch.from_numpy(a.astype(np.int64)) for a in w))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(words(o), words(r))


@pytest.mark.parametrize("sample,seed", [(0, 0), (7, 0), (3, 12345),
                                         (2**32 - 1, 2**31 + 5)])
def test_sampler_blocks_bit_exact(sample, seed):
    pix = np.arange(5000, dtype=np.uint32)
    js = jrng.make_sampler_v(jnp.asarray(pix), jnp.uint32(sample),
                             jnp.uint32(seed))
    ts = trng.make_sampler_v(torch.from_numpy(pix.astype(np.int64)), sample,
                             seed)
    for a, b in ((js.b0, ts.b0), (js.b1, ts.b1), (js.b2, ts.b2),
                 (js.b3, ts.b3)):
        np.testing.assert_array_equal(words(b), words(a))
    for _ in range(6):
        js, ju = jrng.next_block4_v(js)
        ts, tu = trng.next_block4_v(ts)
        np.testing.assert_array_equal(words(ts.dim), words(js.dim))
        for a, b in zip(ju, tu):
            np.testing.assert_array_equal(npy(b), npy(a))


def test_other_sampler_kinds_raise():
    """The SOBOL kind, which raised before the samplers were ported (the
    name is kept), draws the reference's blocks bit for bit (every kind:
    test_torch_sampler.py); the MCMC table mode still raises."""
    pix = np.arange(64, dtype=np.uint32)
    js = jrng.make_sampler_v(jnp.asarray(pix), jnp.uint32(3), jnp.uint32(9),
                             kind=jrng.SOBOL, spp=4)
    ts = trng.make_sampler_v(torch.from_numpy(pix.astype(np.int64)), 3, 9,
                             kind=trng.SOBOL, spp=4)
    for _ in range(2):
        js, ju = jrng.next_block4_v(js)
        ts, tu = trng.next_block4_v(ts)
        for a, b in zip(ju, tu):
            np.testing.assert_array_equal(npy(b), npy(a))
    s = trng.make_sampler_v(torch.arange(4), 0, 0).replace(
        table=torch.zeros(4, 2, 4))
    with pytest.raises(NotImplementedError):
        trng.next_block4_v(s)


def _uniforms(rng, n):
    u = rng.random((2, n), dtype=np.float32)
    u[:, :6] = [[0.0, 0.5, 0.5, 0.25, 1 - 2**-24, 0.0],
                [0.0, 0.5, 0.0, 0.75, 1 - 2**-24, 1 - 2**-24]]
    return u


def test_warps():
    u = _uniforms(np.random.default_rng(1), 4096)
    ju = [jnp.asarray(a) for a in u]
    tu = [torch.from_numpy(a) for a in u]
    for a, b in zip(jv.square_to_uniform_disk_concentric(*ju),
                    tv.square_to_uniform_disk_concentric(*tu)):
        close(b, a)
    jh = jv.square_to_cosine_hemisphere(*ju)
    th = tv.square_to_cosine_hemisphere(*tu)
    close_v3(th, jh)
    close(tv.square_to_cosine_hemisphere_pdf(th),
          jv.square_to_cosine_hemisphere_pdf(jh))
    for a, b in zip(jv.square_to_uniform_triangle(*ju),
                    tv.square_to_uniform_triangle(*tu)):
        close(b, a)


def test_frames_and_vector_ops():
    rng = np.random.default_rng(2)
    n = unit_vectors(rng, 2048)
    n[:3] = [[0, 0, 1], [0, 0, -1], [0, 1, 0]]
    w = rng.normal(size=(2048, 3)).astype(np.float32)
    js, jt = jv.coordinate_system(jv3(n))
    ts, tt = tv.coordinate_system(tv3(n))
    close_v3(ts, js)
    close_v3(tt, jt)
    jf, tf = (js, jt, jv3(n)), (ts, tt, tv3(n))
    close_v3(tv.to_local(tf, tv3(w)), jv.to_local(jf, jv3(w)))
    close_v3(tv.to_world(tf, tv3(w)), jv.to_world(jf, jv3(w)))
    close_v3(tv3(w).normalized(), jv3(w).normalized())
    close_v3(tv3(w).cross(tv3(n)), jv3(w).cross(jv3(n)))
    a = jnp.asarray(w[:, 0])
    b = jnp.asarray(np.where(np.arange(2048) % 5 == 0, 0.0, w[:, 1]))
    close(tv.safe_div(torch.tensor(npy(a)), torch.tensor(npy(b))),
          jv.safe_div(a, b))
    for x, y in zip(tv.spherical_coordinates(tv3(n)),
                    jv.spherical_coordinates(jv3(n))):
        close(x, y)


def test_sample_ray_v():
    jscene, _ = jax_cornell()
    tscene = bridged(jscene)
    u = _uniforms(np.random.default_rng(3), 8192)
    lens = np.random.default_rng(4).random((2, 8192), dtype=np.float32)
    jo, jd, jw = jsensor.sample_ray_v(jscene.sensor, *(jnp.asarray(a) for a
                                                       in (*u, *lens)))
    to, td, tw = tsensor.sample_ray_v(tscene.sensor, *(torch.from_numpy(a)
                                                       for a in (*u, *lens)))
    close_v3(to, jo)
    close_v3(td, jd)
    close(tw, jw)


def test_other_sensor_types_raise():
    """The orthographic sensor, which raised before the sensors were
    ported (the name is kept), maps film samples to the reference's rays
    (every type: test_torch_sensor_film.py)."""
    import dataclasses

    jscene = jax_cornell()[0]
    tscene = bridged(jscene)
    js = jscene.sensor.replace(type=jsensor.S_ORTHOGRAPHIC)
    ts = dataclasses.replace(tscene.sensor, type=tsensor.S_ORTHOGRAPHIC)
    u = _uniforms(np.random.default_rng(5), 1024)
    jo, jd, _ = jsensor.sample_ray_v(js, *(jnp.asarray(a) for a in (*u, *u)))
    to, td, _ = tsensor.sample_ray_v(ts, *(torch.from_numpy(a)
                                           for a in (*u, *u)))
    close_v3(to, jo)
    close_v3(td, jd)
