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
    shape = torch.zeros(2, dtype=torch.int32)
    o = V3(*(torch.zeros(4) for _ in range(3)))
    ci.closest_tris_v(*tris, o, o, 0.0, 1.0)
    ci.closest_hit_v(*tris, shape, o, o, 0.0, 1.0)
    ci.anyhit_tris_v(*tris, o, o, 0.0, 1.0)
    assert ci.closest_tris_v.launches == 0 and ci.anyhit_tris_v.launches == 0
    meta = V3(*(torch.zeros(4, device="meta") for _ in range(3)))
    mtris = [torch.zeros(2, 3, device="meta") for _ in range(3)]
    with pytest.raises(ValueError):
        ci.closest_tris_v(*mtris, meta, meta, 0.0, 1.0)
    with pytest.raises(ValueError):
        ci.closest_hit_v(*mtris, shape.to("meta"), meta, meta, 0.0, 1.0)
    with pytest.raises(ValueError):
        ci.anyhit_tris_v(*mtris, meta, meta, 0.0, 1.0)


def _bound_forms(value, n):
    """The forms a wrapper takes one tmin/tmax value in."""
    full = torch.full((2 * n,), value, dtype=torch.float32)
    return {"number": value, "0-dim": torch.tensor(value),
            "expanded": torch.tensor(value).expand(n),
            "strided": full[::2], "(N,)": full[:n].clone()}


@pytest.mark.parametrize("form", ["number", "0-dim", "expanded", "strided"])
def test_plain_versions_take_every_bound_form(form):
    """tmin/tmax as numbers, 0-dim, expanded and strided tensors give the
    outputs of contiguous (N,) tensors bit for bit; in an (N,) tmax a NaN
    lane admits no hit and leaves the other lanes as they were."""
    rng = np.random.default_rng(12)
    n = 2000
    g = bridged(jax_cornell()[0]).geom
    tris, shape = (g.tri_p0, g.tri_e1, g.tri_e2), g.tri_shape
    o, d = (tv3(a) for a in _cornell_rays(rng, n))
    tmin, tmax = _bound_forms(1e-4, n), _bound_forms(2.5, n)
    ref = (ci.closest_tris_v(*tris, o, d, tmin["(N,)"], tmax["(N,)"])
           + ci.closest_hit_v(*tris, shape, o, d, tmin["(N,)"], tmax["(N,)"])
           + (ci.anyhit_tris_v(*tris, o, d, tmin["(N,)"], tmax["(N,)"]),))
    got = (ci.closest_tris_v(*tris, o, d, tmin[form], tmax[form])
           + ci.closest_hit_v(*tris, shape, o, d, tmin[form], tmax[form])
           + (ci.anyhit_tris_v(*tris, o, d, tmin[form], tmax[form]),))
    assert bool(ref[4].any()) and not bool(ref[4].all())
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)

    nan = tmax["(N,)"].clone()
    nan[::5] = float("nan")
    t, u, v, prim, found = ci.closest_tris_v(*tris, o, d, tmin[form], nan)
    blocked = ci.anyhit_tris_v(*tris, o, d, tmin[form], nan)
    lanes = torch.arange(n) % 5 == 0
    assert not found[lanes].any() and not blocked[lanes].any()
    assert (t[lanes] == ci.BIG).all() and (prim[lanes] == 0).all()
    for a, b in zip((t, u, v, prim, found, blocked), ref[:5] + ref[-1:]):
        assert torch.equal(a[~lanes], b[~lanes])


@pytest.mark.parametrize("value", [1e-4, 0.1, 1.0 / 3.0, 2.5, 1e30, 3.0e37,
                                   -7.0e-39, float("inf"), float("nan")])
def test_float_argument_rounds_as_the_plain_version(value):
    """A number reaches the kernels as ``ctypes.c_float``: the float32 that
    ``torch.full`` gives the plain version, bit for bit."""
    import ctypes
    import struct

    kernel = struct.pack("<f", ctypes.c_float(value).value)
    plain = torch.full((1,), value, dtype=torch.float32).numpy().tobytes()
    assert kernel == plain


def test_kernel_arguments():
    """What the kernel wrappers hand the entry points (checked here, where
    no kernel runs): numbers as (null, 0, value), 0-dim and expanded
    tensors with stride 0, strided ones with their stride; wrong shapes,
    dtypes and devices raise."""
    n = 6
    x = torch.arange(2 * n, dtype=torch.float32)
    cpu = torch.device("cpu")
    assert ci._bound(0.5, n, cpu)[0] == (None, 0, 0.5)
    zero = torch.tensor(0.5)
    assert ci._bound(zero, n, cpu)[0] == (zero.data_ptr(), 0, 0.0)
    assert ci._bound(zero.expand(n), n, cpu)[0][1] == 0
    assert ci._bound(x[::2], n, cpu)[0] == (x.data_ptr(), 2, 0.0)
    assert ci._bound(torch.tensor(0.5, dtype=torch.float64), n,
                     cpu)[1].dtype == torch.float32
    for bad in (x[:n - 1], x[:n].double(), x[:n].reshape(2, 3),
                torch.zeros(n, device="meta")):
        with pytest.raises(ValueError):
            ci._bound(bad, n, cpu)

    tris = [torch.zeros(3, 3) for _ in range(3)]
    o = V3(*(x[k:k + n] for k in range(3)))
    args, keep, m, dev = ci._kernel_args(*tris, o, o, 1e-4, x[::2])
    assert (m, dev) == (n, cpu) and args[-2:] == [3, n]
    assert args[6:12] == [None, 0, 1e-4, x.data_ptr(), 2, 0.0]
    assert args[:3] == [c.data_ptr() for c in o]
    assert args[12:15] == [a.data_ptr() for a in tris]


@pytest.mark.parametrize("soup", ["cornell", "random512"])
def test_hit_record_equals_the_merge(soup):
    """The closest-hit kernel's record epilogue (its plain version) equals
    ``intersect.merge_hits`` of the plain closest hit bit for bit on a
    scene without spheres and disks; ``intersect_v`` returns it there."""
    import dataclasses

    rng = np.random.default_rng(13)
    n = 4000
    g = bridged(jax_cornell()[0]).geom
    if soup == "cornell":
        o, d = (tv3(a) for a in _cornell_rays(rng, n))
    else:
        p0, e1, e2 = (torch.from_numpy(a) for a in _random_soup(rng, 512))
        g = dataclasses.replace(
            g, tri_p0=p0, tri_e1=e1, tri_e2=e2, n_tris=512,
            tri_shape=torch.from_numpy(rng.integers(0, 9, 512, np.int32)))
        o = tv3(rng.uniform(-1.5, 1.5, (n, 3)))
        d = tv3(unit_vectors(rng, n))
    tris = (g.tri_p0, g.tri_e1, g.tri_e2)
    for tmin, tmax in ((1e-4, 1e30),
                       (torch.tensor(1e-4),
                        torch.from_numpy(rng.uniform(0, 3, n).astype(
                            np.float32)))):
        raw = ci.closest_tris_plain(*tris, o, d, tmin, tmax)
        merged = tisect.merge_hits(g, o, d, tmin, tmax, raw)
        rec = ci.hit_record_plain(g.tri_shape, *raw)
        hit = tisect.intersect_v(g, o, d, tmin, tmax)
        assert bool(raw[4].any()) and not bool(raw[4].all())
        for k, a in zip(("t", "kind", "prim", "shape", "u", "v"), rec):
            b = getattr(merged, k)
            assert a.dtype == b.dtype and torch.equal(a, b), k
            assert torch.equal(getattr(hit, k), b), k


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
