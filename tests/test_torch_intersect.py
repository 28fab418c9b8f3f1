"""Port vs reference: brute-force intersection (``accel/cuda_intersect.py``
plain versions and wrappers, ``accel/intersect.py``) on the Cornell box, a
random 512-triangle soup and a scene with spheres and a disk."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (bridged, close, jax_cornell,
                                jax_shapes_scene, jv3, npy, tv3,
                                unit_vectors)

from mitsuba_im_tpu.accel import intersect as jisect
from mitsuba_im_tpu_torch.accel import cuda_intersect as ci
from mitsuba_im_tpu_torch.accel import intersect as tisect
from mitsuba_im_tpu_torch.core.v3 import V3

torch.set_num_threads(2)


def _tie_or_equal(t_ref, prim_ref, t_out, prim_out, found_ref, found_out):
    """found/prim equal except exact-t ties: a differing prim must come with
    the same t, and such rays stay rare."""
    np.testing.assert_array_equal(found_out, found_ref)
    diff = found_ref & (prim_out != prim_ref)
    assert diff.mean() < 1e-3
    np.testing.assert_allclose(t_out[diff], t_ref[diff], rtol=1e-5)


def _cornell_rays(rng, n):
    """Rays from inside the box and from the camera side, all directions."""
    o = np.concatenate([
        rng.uniform([-0.99, 0.01, -0.99], [0.99, 1.99, 0.99], (n // 2, 3)),
        rng.uniform([-1.5, 0.0, 2.0], [1.5, 2.0, 4.0], (n - n // 2, 3))])
    return o.astype(np.float32), unit_vectors(rng, n)


def _random_soup(rng, T):
    p0 = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (T, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (T, 3)).astype(np.float32)
    return p0, e1, e2


def _jax_closest(p0, e1, e2, o, d, tmin, tmax):
    """The reference's jnp branch (intersect.py:147-152)."""
    th, tt, tu, tv = jisect._moeller_trumbore(
        jnp.asarray(o)[:, None], jnp.asarray(d)[:, None], jnp.asarray(p0)[None],
        jnp.asarray(e1)[None], jnp.asarray(e2)[None],
        jnp.asarray(tmin)[:, None], jnp.asarray(tmax)[:, None])
    ti, tbest, tvalid = jisect._closest_from_masked(tt, th)
    u = jnp.take_along_axis(tu, ti[:, None], axis=-1)[:, 0]
    v = jnp.take_along_axis(tv, ti[:, None], axis=-1)[:, 0]
    return tuple(npy(a) for a in (tbest, u, v, ti, tvalid, jnp.any(th, -1)))


@pytest.mark.parametrize("soup", ["cornell", "random512"])
def test_tris_plain_vs_reference(soup, monkeypatch):
    rng = np.random.default_rng(10)
    n = 6000
    if soup == "cornell":
        g = jax_cornell()[0].geom
        p0, e1, e2 = (npy(a) for a in (g.tri_p0, g.tri_e1, g.tri_e2))
        o, d = _cornell_rays(rng, n)
    else:
        p0, e1, e2 = _random_soup(rng, 512)
        o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
        d = unit_vectors(rng, n)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = rng.uniform(0.0, 4.0, n).astype(np.float32)
    tmax[: n // 2] = 1e30
    t_ref, u_ref, v_ref, i_ref, f_ref, b_ref = _jax_closest(
        p0, e1, e2, o, d, tmin, tmax)

    # several ray chunks, so the chunk seams are exercised too
    monkeypatch.setattr(ci, "_CHUNK_ELEMS", 512 * 1000)
    tris = [torch.tensor(a) for a in (p0, e1, e2)]
    t, u, v, prim, found = ci.closest_tris_v(
        *tris, tv3(o), tv3(d), 1e-4, torch.from_numpy(tmax))
    t, u, v, prim, found = (npy(a) for a in (t, u, v, prim, found))
    assert f_ref.any() and not f_ref.all()
    _tie_or_equal(t_ref, i_ref, t, prim, f_ref, found)
    same = f_ref & (prim == i_ref)
    for a, b in ((t, t_ref), (u, u_ref), (v, v_ref)):
        close(a[same], b[same])
    assert (t[~found] == ci.BIG).all() and (prim[~found] == 0).all()
    assert (u[~found] == 0).all() and (v[~found] == 0).all()

    blocked = ci.anyhit_tris_v(*tris, tv3(o), tv3(d), torch.tensor(1e-4),
                               torch.from_numpy(tmax))
    np.testing.assert_array_equal(npy(blocked), b_ref)


def test_wrappers_route_by_device():
    """CPU tensors reach the plain versions (no launch counted); any other
    device reaches a kernel or raises, never a plain version."""
    ci.reset_launch_counts()
    tris = [torch.zeros(2, 3) for _ in range(3)]
    o = V3(*(torch.zeros(4) for _ in range(3)))
    ci.closest_tris_v(*tris, o, o, 0.0, 1.0)
    ci.anyhit_tris_v(*tris, o, o, 0.0, 1.0)
    assert ci.closest_tris_v.launches == 0 and ci.anyhit_tris_v.launches == 0
    meta = V3(*(torch.zeros(4, device="meta") for _ in range(3)))
    mtris = [torch.zeros(2, 3, device="meta") for _ in range(3)]
    with pytest.raises(ValueError):
        ci.closest_tris_v(*mtris, meta, meta, 0.0, 1.0)
    with pytest.raises(ValueError):
        ci.anyhit_tris_v(*mtris, meta, meta, 0.0, 1.0)


@pytest.mark.parametrize("bad", ["too_many_tris", "dtype", "shape"])
def test_wrappers_check_arguments(bad):
    T = 513 if bad == "too_many_tris" else 4
    tris = [torch.zeros(T, 3) for _ in range(3)]
    o = V3(*(torch.zeros(8) for _ in range(3)))
    if bad == "dtype":
        o = V3(o.x.double(), o.y, o.z)
    if bad == "shape":
        tris[1] = torch.zeros(T, 2)
    with pytest.raises(ValueError):
        ci.closest_tris_v(*tris, o, o, 0.0, 1.0)


def _hit_close(th, jh):
    for k in ("kind", "shape"):
        np.testing.assert_array_equal(npy(getattr(th, k)), npy(getattr(jh, k)))
    _tie_or_equal(npy(jh.t), npy(jh.prim), npy(th.t), npy(th.prim),
                  npy(jh.kind) > 0, npy(th.kind) > 0)
    same = npy(th.prim) == npy(jh.prim)
    for k in ("t", "u", "v"):
        close(npy(getattr(th, k))[same], npy(getattr(jh, k))[same])


@pytest.mark.parametrize("which", ["cornell", "shapes"])
def test_intersect_and_occluded_v(which):
    rng = np.random.default_rng(11)
    jscene = jax_cornell()[0] if which == "cornell" else jax_shapes_scene()
    tscene = bridged(jscene)
    n = 8000
    if which == "cornell":
        o, d = _cornell_rays(rng, n)
    else:
        o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
        d = unit_vectors(rng, n)
    jh = jisect.intersect_v(jscene.geom, jv3(o), jv3(d), 1e-4, 1e30)
    th = tisect.intersect_v(tscene.geom, tv3(o), tv3(d), 1e-4, 1e30)
    kinds = set(np.unique(npy(jh.kind)).tolist())
    assert kinds == ({0, 1} if which == "cornell" else {0, 1, 2, 3})
    _hit_close(th, jh)

    tmax = rng.uniform(0.0, 3.0, n).astype(np.float32)
    jb = jisect.occluded_v(jscene.geom, jv3(o), jv3(d), 1e-4, jnp.asarray(tmax))
    tb = tisect.occluded_v(tscene.geom, tv3(o), tv3(d), 1e-4,
                           torch.from_numpy(tmax))
    np.testing.assert_array_equal(npy(tb), npy(jb))


def test_large_scene_raises():
    """Above the brute-force bound a scene is traversed through its
    hierarchy; a geometry that comes without one raises."""
    import dataclasses

    g = dataclasses.replace(bridged(jax_cornell()[0]).geom, n_tris=513)
    o = V3(*(torch.zeros(2) for _ in range(3)))
    with pytest.raises(ValueError, match="hierarchy"):
        tisect.intersect_v(g, o, o, 1e-4, 1e30)
    with pytest.raises(ValueError, match="hierarchy"):
        tisect.occluded_v(g, o, o, 1e-4, 1e30)
