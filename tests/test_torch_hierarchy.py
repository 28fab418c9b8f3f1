"""Port vs reference: the two-level cluster hierarchy
(``mitsuba_im_tpu_torch/accel/bvh.py``, ``accel/hierarchy.py``,
``accel/cuda_hierarchy.py``) against ``mitsuba_im_tpu.accel`` on the CPU.

Tables must equal the reference's bit for bit.  Traversal results: found
and inst exactly, prim exactly except rays whose best hit ties on t, t to
rel 1e-5 (RTOL of test_torch_helpers), and the barycentrics u, v to rel
1e-5 or abs 1e-5 (UV_ATOL): XLA's CPU backend contracts products and sums
into fused multiply-adds, and on the small triangles of the displaced
sphere the cancellation in Moeller-Trumbore's differences scales those
last-bit differences by about 1/|det|.  The port's own arithmetic is held
exactly: its t, u, v equal a float32 numpy evaluation, one rounding per
operation, at the hit triangle, bit for bit.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import close, npy, tv3, unit_vectors

from mitsuba_im_tpu.accel import bvh as jbvh
from mitsuba_im_tpu.accel import hierarchy as jhy
from mitsuba_im_tpu_torch.accel import bvh as tbvh
from mitsuba_im_tpu_torch.accel import cuda_hierarchy as ch
from mitsuba_im_tpu_torch.accel import hierarchy as thy
from mitsuba_im_tpu_torch.core.v3 import V3
from mitsuba_im_tpu_torch.scenes import displaced_sphere

torch.set_num_threads(2)

UV_ATOL = 1e-5


def _soup(rng, n):
    p0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    return p0, e1, e2


def _sphere_soup():
    pos, idx = displaced_sphere(3000)
    p0 = pos[idx[:, 0]]
    return tuple(a.astype(np.float32) for a in (
        p0, pos[idx[:, 1]] - p0, pos[idx[:, 2]] - p0))


def _mt_numpy(o, d, p0, e1, e2):
    """Moeller-Trumbore in float32 numpy, one rounding per operation, in
    the kernel's order (rows of rays against rows of triangles)."""
    px = d[:, 1] * e2[:, 2] - d[:, 2] * e2[:, 1]
    py = d[:, 2] * e2[:, 0] - d[:, 0] * e2[:, 2]
    pz = d[:, 0] * e2[:, 1] - d[:, 1] * e2[:, 0]
    det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
    inv = np.float32(1.0) / det
    tx, ty, tz = (o - p0).T
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1[:, 2] - tz * e1[:, 1]
    qy = tz * e1[:, 0] - tx * e1[:, 2]
    qz = tx * e1[:, 1] - ty * e1[:, 0]
    v = (d[:, 0] * qx + d[:, 1] * qy + d[:, 2] * qz) * inv
    t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv
    return t, u, v


def _rot_y(deg):
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]], np.float32)


def _instances():
    """One BLAS (a 1500-triangle soup) under three transforms."""
    p0, e1, e2 = _soup(np.random.default_rng(62), 1500)
    mats = [np.concatenate([np.eye(3, dtype=np.float32),
                            np.zeros((3, 1), np.float32)], 1),
            np.concatenate([_rot_y(35.0) * 1.3,
                            np.array([[2.5], [0.2], [-0.4]], np.float32)], 1),
            np.concatenate([_rot_y(-70.0),
                            np.array([[-2.0], [1.0], [1.5]], np.float32)], 1)]
    blas = [(p0, e1, e2, np.arange(len(p0), dtype=np.int64))]
    return blas, [(0, m) for m in mats]


def _both(case):
    """(reference Hierarchy, port Hierarchy) of a test case."""
    if case == "instanced":
        blas, inst = _instances()
        return (jhy.build_hierarchy_instanced(blas, inst),
                thy.build_hierarchy_instanced(blas, inst, "cpu"))
    tris = (_sphere_soup() if case == "sphere"
            else _soup(np.random.default_rng(60), 3000))
    return jhy.build_hierarchy(*tris), thy.build_hierarchy(*tris, "cpu")


@pytest.mark.parametrize("case", ["soup3k", "sphere", "instanced"])
def test_tables_bit_exact(case):
    """BVH arrays and every hierarchy table equal the reference's."""
    rng = np.random.default_rng(61)
    p0, e1, e2 = _soup(rng, 3000)
    jlo, jhi = jbvh.tri_bounds(p0, e1, e2)
    tlo, thi = tbvh.tri_bounds(p0, e1, e2)
    np.testing.assert_array_equal(tlo, jlo)
    np.testing.assert_array_equal(thi, jhi)
    ja = jbvh.build_bvh_arrays(jlo, jhi, leaf_size=64)
    ta = tbvh.build_bvh_arrays(tlo, thi, leaf_size=64)
    assert ja.keys() == ta.keys()
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)

    jh, th = _both(case)
    for k in thy.HIERARCHY_LEAVES:
        a, b = npy(getattr(jh, k)), npy(getattr(th, k))
        assert a.shape == b.shape, k
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    for k in ("n_supers", "n_tris", "indirect"):
        assert getattr(th, k) == getattr(jh, k), k
    assert th.childs.shape[1] == thy.CROW == 384
    assert th.blocks.shape[1] == thy.ROW == 640


CASES = {
    "closest_soup": dict(tris="soup3k"),
    "closest_sphere": dict(tris="sphere"),
    "anyhit_finite_tmax": dict(tris="soup3k", any_hit=True, finite=True),
    "closest_finite_tmax_masked": dict(tris="soup3k", finite=True,
                                       masked=True),
    "anyhit_masked": dict(tris="sphere", any_hit=True, finite=True,
                          masked=True),
    "closest_instanced": dict(tris="instanced"),
    "anyhit_instanced": dict(tris="instanced", any_hit=True, finite=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_traversal_vs_reference(case):
    cfg = CASES[case]
    rng = np.random.default_rng(63)
    jh, th = _both(cfg["tris"])
    n = 1024
    span = 0.12 if cfg["tris"] == "sphere" else (4.0 if cfg["tris"]
                                                  == "instanced" else 2.0)
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = unit_vectors(rng, n)
    tmax = np.full(n, 1e30, np.float32)
    if cfg.get("finite"):
        tmax = rng.uniform(0.0, 2.0 * span, n).astype(np.float32)
    act = rng.random(n) < 0.5 if cfg.get("masked") else None
    any_hit = cfg.get("any_hit", False)

    ref = jhy.intersect_hierarchy(
        jh, jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.asarray(tmax),
        any_hit=any_hit, active=None if act is None else jnp.asarray(act))
    ref = {k: npy(a) for k, a in ref.items()}
    hits, counts = thy.intersect_hierarchy_plain(
        th, tv3(o), tv3(d), 1e-4, torch.from_numpy(tmax), any_hit=any_hit,
        active=None if act is None else torch.from_numpy(act))
    out = {k: npy(getattr(hits, k)) for k in hits._fields}

    found = ref["found"]
    assert found.any() and not found.all()
    np.testing.assert_array_equal(out["found"], found)
    if act is not None:
        assert not found[~act].any()
        assert (npy(counts.sweeps)[~act] == 0).all()
    # a hit needs a sweep and a cluster test; every cluster test a pick
    assert (npy(counts.sweeps)[found] >= 1).all()
    assert (npy(counts.clusters)[found] >= 1).all()
    assert (npy(counts.clusters) <= npy(counts.child_rows)).all()
    if any_hit:
        return
    np.testing.assert_array_equal(out["inst"][found], ref["inst"][found])
    tie = found & (out["prim"] != ref["prim"])
    assert tie.mean() < 1e-3
    close(out["t"][tie], ref["t"][tie])
    same = found & ~tie
    for k in ("t", "u", "v"):
        close(out[k][same], ref[k][same],
              atol=UV_ATOL if k in ("u", "v") else 1e-6)
    if cfg["tris"] == "instanced":
        assert len(set(out["inst"][found].tolist())) == 3
        return
    tris = (_sphere_soup() if cfg["tris"] == "sphere"
            else _soup(np.random.default_rng(60), 3000))
    pid = out["prim"][found]
    exact = _mt_numpy(o[found], d[found], *(a[pid] for a in tris))
    for k, a in zip(("t", "u", "v"), exact):
        np.testing.assert_array_equal(out[k][found], a, err_msg=k)


def test_super_list_yields_the_sweeps_sequence():
    """The per-ray super list of ``csrc/hier_traverse.cu``: a numpy model
    lists every super the first sweep enters ((tn, id) with tn <= tf and
    tn < FAR at the first best t), then takes the lex-gated minimum over
    that list among entries with tn <= the current best t.  Repeated full
    sweeps (``_sweep``) with a shrinking best t give the same sequence of
    (tn, id).  Duplicate boxes make exact-tn ties; a row of boxes along x
    makes rays enter more supers than the kernel's list holds."""
    rng = np.random.default_rng(64)
    lo = rng.uniform(-2.0, 2.0, (200, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.05, 1.5, (200, 3))).astype(np.float32)
    dup = rng.choice(200, 40, replace=False)
    row = np.stack([np.arange(100) * 0.3 - 1.0, np.full(100, -0.5),
                    np.full(100, -0.5)], 1).astype(np.float32)
    lo = np.concatenate([lo, lo[dup], row])
    hi = np.concatenate([hi, hi[dup], row + np.float32(1.0)])
    S = len(lo)
    h = SimpleNamespace(n_supers=S, swp_lo=torch.from_numpy(lo.T.copy()),
                        swp_hi=torch.from_numpy(hi.T.copy()))

    n = 256
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = unit_vectors(rng, n)
    o[: n // 4] = rng.uniform(-0.3, 0.3, (n // 4, 3))  # along the row
    o[: n // 4, 0] = -5.0
    d[: n // 4] = np.array([1.0, 0.0, 0.0], np.float32) + rng.uniform(
        -0.01, 0.01, (n // 4, 3)).astype(np.float32)
    tmax = np.where(rng.random(n) < 0.5, np.float32(1e30),
                    rng.uniform(1.0, 40.0, n)).astype(np.float32)
    tmax[:8] = 1e30  # these walk the whole row: no cut below
    tmin = np.full(n, 1e-4, np.float32)
    inv = np.stack([thy._safe_inv(torch.from_numpy(d[:, k].copy())).numpy()
                    for k in range(3)], 1)

    # the model: the list of the first sweep, in float32 numpy
    a0 = (lo[None] - o[:, None]) * inv[:, None]
    a1 = (hi[None] - o[:, None]) * inv[:, None]
    mn, mx = np.minimum(a0, a1), np.maximum(a0, a1)
    tb = np.minimum(np.float32(thy.BIG), tmax)
    tn = np.maximum(np.maximum(mn[..., 0], mn[..., 1]),
                    np.maximum(mn[..., 2], tmin[:, None]))
    tf = np.minimum(np.minimum(mx[..., 0], mx[..., 1]),
                    np.minimum(mx[..., 2], tb[:, None]))
    listed = (tn <= tf) & (tn < thy.FAR)
    assert (listed.sum(1) > ch.LIST_CAPACITY).any()
    assert (listed[:, 200:240] & listed[:, dup]).any()  # exact-tn ties
    ids = np.arange(S)

    sg_t = np.full(n, -thy.BIG, np.float32)
    sg_c = np.full(n, -1, np.int32)
    live = np.ones(n, bool)
    steps = 0
    while live.any():
        r = np.flatnonzero(live)
        se, sid = thy._sweep(
            h, [torch.from_numpy(o[r, k].copy()) for k in range(3)],
            [torch.from_numpy(inv[r, k].copy()) for k in range(3)],
            torch.from_numpy(tmin[r]), torch.from_numpy(tb[r]),
            torch.from_numpy(sg_t[r]), torch.from_numpy(sg_c[r]))
        se, sid = se.numpy(), sid.numpy()
        gate = (tn[r] > sg_t[r, None]) | ((tn[r] == sg_t[r, None])
                                          & (ids > sg_c[r, None]))
        cand = listed[r] & (tn[r] <= tb[r, None]) & gate
        e = np.where(cand, tn[r], np.inf)
        m_t = e.min(1)
        got = cand.any(1)
        m_id = np.where(e == m_t[:, None], ids, S).min(1)
        np.testing.assert_array_equal(se < thy.BIG, got)
        np.testing.assert_array_equal(se[got], m_t[got])
        np.testing.assert_array_equal(sid[got], m_id[got])
        # enter it; sometimes a hit inside shrinks the best t
        sg_t[r[got]], sg_c[r[got]] = se[got], sid[got]
        cut = got & (rng.random(len(r)) < 0.3) & (r >= 8)
        f = rng.random(cut.sum()).astype(np.float32)
        tb[r[cut]] = np.minimum(tb[r[cut]], se[cut] + (np.minimum(
            tb[r[cut]], np.float32(50.0)) - se[cut]) * f)
        live[r[~got]] = False
        steps += 1
    assert steps > ch.LIST_CAPACITY


def test_wrappers_route_by_device():
    """CPU tensors reach the plain version (no launch counted); any other
    device reaches the kernel or raises."""
    _, th = _both("soup3k")
    ch.reset_launch_counts()
    o = V3(*(torch.zeros(4) for _ in range(3)))
    d = V3(torch.ones(4), torch.zeros(4), torch.zeros(4))
    t, u, v, prim, inst, found = ch.hier_closest(th, o, d, 1e-4, 1e30)
    blocked = ch.hier_anyhit(th, o, d, 1e-4, 1e30)
    assert torch.equal(found, blocked)
    assert ch.hier_closest.launches == 0 and ch.hier_anyhit.launches == 0
    meta = V3(*(torch.zeros(4, device="meta") for _ in range(3)))
    with pytest.raises(ValueError):
        ch.hier_closest(th, meta, meta, 1e-4, 1e30)
    with pytest.raises(ValueError):
        ch.hier_anyhit(th, meta, meta, 1e-4, 1e30)
