"""Two-level cluster hierarchy: the large-scene intersector
(``mitsuba_im_tpu/accel/hierarchy.py``): its tables, and the plain PyTorch
version of the traversal that ``csrc/hier_traverse.cu`` runs on the card.

Tables (built on the host with the reference's arithmetic, so they equal
the JAX package's bit for bit):

- **clusters**: at most ``LEAF`` = 64 triangles each (merged SAH leaves),
  one packed row per cluster, ``blocks`` (C, ROW) f32: the nine component
  planes p0x..e2z of 64 slots each, then the 64 primitive ids bitcast to
  f32.  Padded slots are all zero (det == 0 never hits).
- **supers**: at most ``SUP`` = 64 clusters each (a second SAH build over
  the cluster boxes).  ``childs`` (S, CROW) holds each super's 64 child
  boxes as planes [lox loy loz hix hiy hiz]; padded children sit at the
  point box ``FAR`` and never pass a slab test.  ``swp_lo``/``swp_hi``
  (3, S_pad) are the super boxes, transposed and padded with ``FAR``.

``ROW`` = 640 and ``CROW`` = 384.  (The reference's comments at
``hierarchy.py:55-56`` say 1280 and 768, which is wrong: 64 x 9 + 64 = 640
and 64 x 6 = 384.)

Traversal (:func:`intersect_hierarchy_plain`) has the lockstep semantics of
the reference's ``_make_state`` / ``_one_step``: a root-box prepass, then
per step a lex-gated nearest-super sweep (entry t, then super id) for lanes
without a super, a lex-gated nearest child of the current super, and one
Moeller-Trumbore cluster test, until no lane is active.  It compacts the
active lanes with an index every step instead of porting the TPU's
retire-cursor driver, which is result-neutral (``tests/test_driver_equiv.py``).
Two choices differ from the reference in form only:

- child entries are recomputed at every pick with the slab's far end
  clipped by the current best t, where the reference caches them when it
  enters a super (clipped by the best t of that moment) and gates them by
  the current best t afterwards.  A child passes in the reference iff
  ``ctn <= min(far, t_enter)``, ``ctn < FAR`` and ``ctn <= t_now``; since
  ``t_now <= t_enter`` that is ``ctn <= min(far, t_now)`` and
  ``ctn < FAR``, the test here.  ``ctn`` itself does not depend on t.
- the sweep covers the ``n_supers`` real supers, not the padding: a pad
  box at ``FAR`` could pass only for a direction with every |d_i| > 1,
  which no caller makes.

Shared-BLAS instancing (:func:`build_hierarchy_instanced`) is traversed as
the reference does: the ray enters a super's instance space through
``inst_inv`` without renormalising its direction, so t stays world t.

Deformable motion (:func:`build_hierarchy_motion`): one SAH build over the
union of the two keyframes' triangle boxes, both frames packed with the
same leaf grouping (``blocks`` and ``blocks1``), cluster, child and super
boxes the union over the shutter.  A traversal at the pass's shutter time
``time`` (:meth:`Hierarchy.at_time`) lerps the nine geometric planes of
each cluster row it tests as ``(1 - time) * blocks + time * blocks1``, in
float32 with the products and the sum rounded one by one (the reference's
XLA driver, ``hierarchy.py:573-579``; the kernel is built without FMA
contraction), and reads the primitive ids from frame 0.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import Float, Int, host_tensor
from ..core.v3 import V3
from . import bvh as bvh_mod
from .cuda_intersect import _rays

LEAF = 64  # triangles per cluster
SUP = 64  # clusters per super
ROW = LEAF * 9 + LEAF  # 640: packed cluster row (tris + prim ids)
CROW = SUP * 6  # 384: packed child-AABB row
BIG = 3.0e37
FAR = 1.0e30  # degenerate padding box (every slab rejects it)
SWEEP_ALIGN = 128  # the reference pads S to this multiple
SWEEP_GROUP = 32  # supers per culling box of the CUDA kernel (one warp)
IBIG = 2 ** 31 - 1
_CHUNK_ELEMS = 1 << 22  # lanes x supers per plain sweep chunk


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    swp_lo: torch.Tensor  # (3, S_pad) world-space super AABB mins
    swp_hi: torch.Tensor  # (3, S_pad)
    sup_inst: torch.Tensor  # (S_pad,) int32 instance id (0 = identity)
    childs: torch.Tensor  # (S, CROW) packed child AABBs, local space
    blocks: torch.Tensor  # (C, ROW) packed cluster rows, local space
    inst_inv: torch.Tensor  # (I, 3, 4) world->local affine transforms
    inst_fwd: torch.Tensor  # (I, 3, 4) local->world
    sup_blas: torch.Tensor  # (S_pad,) int32 world super -> BLAS super row
    # frame-1 cluster rows of a motion hierarchy ((1, 1) zeros otherwise)
    blocks1: torch.Tensor
    n_supers: int = 0
    n_tris: int = 0
    indirect: bool = False  # sup_blas indirection live
    has_motion: bool = False  # blocks1 live: rows lerp at ``time``
    time: float = 0.0  # shutter time, a float32 value

    def at_time(self, t) -> "Hierarchy":
        """The hierarchy at shutter time ``t`` (a float32 value; no
        effect on a static hierarchy)."""
        if not self.has_motion:
            return self
        return dataclasses.replace(self, time=float(np.float32(t)))

    @property
    def instanced(self) -> bool:
        return self.inst_inv.shape[0] > 1

    @functools.cached_property
    def root(self) -> torch.Tensor:
        """(6,) box of the real supers: lo xyz, hi xyz."""
        S = self.n_supers
        return torch.cat([self.swp_lo[:, :S].amin(1),
                          self.swp_hi[:, :S].amax(1)]).contiguous()

    @functools.cached_property
    def sweep_groups(self) -> torch.Tensor:
        """(6, ceil(n_supers / SWEEP_GROUP)) boxes of the runs of
        SWEEP_GROUP consecutive supers: lo xyz, hi xyz, over each super's
        planes taken in order.  The CUDA kernel's first sweep tests a run's
        supers only when the ray enters the run's box; a box holding the
        super's box gives an entry no later and an exit no earlier under
        rounding, so no super the ray enters is skipped."""
        S = self.n_supers
        pad = -S % SWEEP_GROUP
        lo = torch.minimum(self.swp_lo[:, :S], self.swp_hi[:, :S])
        hi = torch.maximum(self.swp_lo[:, :S], self.swp_hi[:, :S])
        lo = torch.nn.functional.pad(lo, (0, pad), value=float("inf"))
        hi = torch.nn.functional.pad(hi, (0, pad), value=float("-inf"))
        return torch.cat([lo.view(3, -1, SWEEP_GROUP).amin(2),
                          hi.view(3, -1, SWEEP_GROUP).amax(2)]).contiguous()

    @property
    def device(self) -> torch.device:
        return self.blocks.device


HIERARCHY_LEAVES = ("swp_lo", "swp_hi", "sup_inst", "childs", "blocks",
                    "inst_inv", "inst_fwd", "sup_blas")
_INT_LEAVES = ("sup_inst", "sup_blas")


def hierarchy_from_arrays(arrays: dict, n_supers: int, n_tris: int,
                          indirect: bool, device, has_motion: bool = False,
                          time: float = 0.0) -> Hierarchy:
    """A Hierarchy from numpy tables: ``HIERARCHY_LEAVES``, and ``blocks1``
    for a motion hierarchy."""
    blocks1 = (arrays["blocks1"] if has_motion
               else np.zeros((1, 1), np.float32))
    return Hierarchy(
        **{k: host_tensor(arrays[k], np.int32 if k in _INT_LEAVES
                          else np.float32, device) for k in HIERARCHY_LEAVES},
        blocks1=host_tensor(blocks1, np.float32, device),
        n_supers=int(n_supers), n_tris=int(n_tris), indirect=bool(indirect),
        has_motion=bool(has_motion), time=float(np.float32(time)))


# ---------------------------------------------------------------------------
# host-side packing (numpy; the reference's arithmetic)
# ---------------------------------------------------------------------------

def _leaf_groups(flat, cap=LEAF):
    """Collapse maximal <= ``cap``-triangle BVH subtrees into clusters:
    walk the skip-threaded DFS and emit every maximal subtree whose
    triangle count fits.  Returns (ids (C, cap), vmask (C, cap)) in DFS
    order."""
    node_count = np.asarray(flat["node_count"])
    node_skip = np.asarray(flat["node_skip"])
    order = np.asarray(flat["order"])
    Nn = len(node_count)
    # prims strictly before node i in DFS order (subtree prim ranges are
    # contiguous in ``order`` because the builder partitions in place)
    pref = np.zeros(Nn + 1, np.int64)
    np.cumsum(node_count, out=pref[1:])

    groups = []
    i = 0
    while 0 <= i < Nn:
        s = node_skip[i] if node_skip[i] >= 0 else Nn
        if pref[s] - pref[i] <= cap:
            groups.append((pref[i], pref[s]))
            i = s if node_skip[i] >= 0 else -1
        else:
            i += 1  # descend into the near child
    C = len(groups)
    ids = np.zeros((C, cap), np.int64)
    vmask = np.zeros((C, cap), bool)
    for g, (b, e) in enumerate(groups):
        c = e - b
        ids[g, :c] = order[b:e]
        vmask[g, :c] = True
    return ids, vmask


def _pack_leaves(flat, soup, tri_ids=None, groups=None):
    """(cl_lo, cl_hi, rows): cluster boxes and packed (C, ROW) rows, over
    ``groups`` (``_leaf_groups(flat)`` when not given)."""
    ids, vmask = _leaf_groups(flat) if groups is None else groups
    C = ids.shape[0]
    tris = np.where(vmask[:, :, None], soup[ids], 0.0).astype(np.float32)
    prim = np.where(vmask, ids if tri_ids is None else tri_ids[ids], 0)
    p0 = tris[..., 0:3]
    c1 = p0 + tris[..., 3:6]
    c2 = p0 + tris[..., 6:9]
    lo3 = np.minimum(np.minimum(p0, c1), c2)
    hi3 = np.maximum(np.maximum(p0, c1), c2)
    cl_lo = np.where(vmask[:, :, None], lo3, np.inf).min(axis=1)
    cl_hi = np.where(vmask[:, :, None], hi3, -np.inf).max(axis=1)
    rows = np.empty((C, ROW), np.float32)
    rows[:, : LEAF * 9] = tris.transpose(0, 2, 1).reshape(C, LEAF * 9)
    rows[:, LEAF * 9:] = prim.astype(np.int32).view(np.float32)
    return cl_lo.astype(np.float32), cl_hi.astype(np.float32), rows


def _pack_supers(cl_lo, cl_hi, rows, rows_extra=()):
    """Second SAH level over the cluster boxes -> (sup_lo, sup_hi,
    childs (S, CROW), blocks (S * SUP, ROW), extra), ``extra`` the tables
    in ``rows_extra`` re-ordered as ``blocks``."""
    flat2 = bvh_mod.build_bvh_arrays(cl_lo, cl_hi, leaf_size=64)
    cids, cmask = _leaf_groups(flat2, cap=SUP)
    S = cids.shape[0]
    ch = np.empty((S, SUP, 6), np.float32)
    ch[..., 0:3] = np.where(cmask[..., None], cl_lo[cids], FAR)
    ch[..., 3:6] = np.where(cmask[..., None], cl_hi[cids], FAR)
    ch = ch.transpose(0, 2, 1)  # (S, 6, SUP)
    # block rows re-ordered so super s owns rows [s*SUP, (s+1)*SUP)
    flatmask = cmask.reshape(-1)
    extra = []
    for r in (rows,) + tuple(rows_extra):
        b = np.zeros((S * SUP, ROW), np.float32)
        b[flatmask] = r[cids.reshape(-1)[flatmask]]
        extra.append(b)
    sup_lo = np.where(cmask[..., None], cl_lo[cids], np.inf).min(axis=1)
    sup_hi = np.where(cmask[..., None], cl_hi[cids], -np.inf).max(axis=1)
    return sup_lo, sup_hi, ch.reshape(S, CROW), extra[0], tuple(extra[1:])


def _pad_sweep(sup_lo, sup_hi):
    S = sup_lo.shape[0]
    S_pad = max(-(-S // SWEEP_ALIGN) * SWEEP_ALIGN, SWEEP_ALIGN)
    lo = np.full((S_pad, 3), FAR, np.float32)
    hi = np.full((S_pad, 3), FAR, np.float32)
    lo[:S] = sup_lo
    hi[:S] = sup_hi
    return lo.T.copy(), hi.T.copy()


def _identity34():
    return np.concatenate([np.eye(3, dtype=np.float32),
                           np.zeros((3, 1), np.float32)], axis=1)


def _from_host(arrays: dict, device) -> Hierarchy:
    return hierarchy_from_arrays(arrays, arrays["n_supers"],
                                 arrays["n_tris"], arrays["indirect"], device,
                                 arrays.get("has_motion", False))


def build_hierarchy(p0, e1, e2, device, leaf_size: int = 64) -> Hierarchy:
    """Two SAH passes: triangles -> clusters, cluster boxes -> supers."""
    p0 = np.asarray(p0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    soup = np.concatenate([p0, e1, e2], axis=1)  # (T, 9)
    lo, hi = bvh_mod.tri_bounds(p0, e1, e2)
    flat = bvh_mod.build_bvh_arrays(lo, hi, leaf_size=leaf_size)
    cl_lo, cl_hi, rows = _pack_leaves(flat, soup)
    sup_lo, sup_hi, childs, blocks, _ = _pack_supers(cl_lo, cl_hi, rows)
    swp_lo, swp_hi = _pad_sweep(sup_lo, sup_hi)
    ident = _identity34()[None]
    return _from_host(dict(
        swp_lo=swp_lo, swp_hi=swp_hi,
        sup_inst=np.zeros(swp_lo.shape[1], np.int32), childs=childs,
        blocks=blocks, inst_inv=ident, inst_fwd=ident.copy(),
        sup_blas=np.zeros(1, np.int32), n_supers=int(sup_lo.shape[0]),
        n_tris=int(len(p0)), indirect=False), device)


def build_hierarchy_motion(p0, e1, e2, q0, f1, f2, device) -> Hierarchy:
    """Deformable two-keyframe hierarchy (frame 0: p0, e1, e2; frame 1:
    q0, f1, f2, the same triangles): one SAH build over the union of the
    two frames' triangle boxes, both frames packed with the same leaf
    grouping, cluster boxes the union of the two frames'."""
    frames = [np.asarray(a, np.float32) for a in (p0, e1, e2, q0, f1, f2)]
    soup_a = np.concatenate(frames[:3], axis=1)
    soup_b = np.concatenate(frames[3:], axis=1)
    lo_a, hi_a = bvh_mod.tri_bounds(*frames[:3])
    lo_b, hi_b = bvh_mod.tri_bounds(*frames[3:])
    flat = bvh_mod.build_bvh_arrays(np.minimum(lo_a, lo_b),
                                    np.maximum(hi_a, hi_b), leaf_size=64)
    groups = _leaf_groups(flat)
    cl_lo_a, cl_hi_a, rows_a = _pack_leaves(flat, soup_a, groups=groups)
    cl_lo_b, cl_hi_b, rows_b = _pack_leaves(flat, soup_b, groups=groups)
    sup_lo, sup_hi, childs, blocks, (blocks1,) = _pack_supers(
        np.minimum(cl_lo_a, cl_lo_b), np.maximum(cl_hi_a, cl_hi_b), rows_a,
        rows_extra=(rows_b,))
    swp_lo, swp_hi = _pad_sweep(sup_lo, sup_hi)
    ident = _identity34()[None]
    return _from_host(dict(
        swp_lo=swp_lo, swp_hi=swp_hi,
        sup_inst=np.zeros(swp_lo.shape[1], np.int32), childs=childs,
        blocks=blocks, inst_inv=ident, inst_fwd=ident.copy(),
        sup_blas=np.zeros(1, np.int32), blocks1=blocks1,
        n_supers=int(sup_lo.shape[0]), n_tris=int(len(frames[0])),
        indirect=False, has_motion=True), device)


def build_hierarchy_instanced(blas_list, instances, device) -> Hierarchy:
    """Shared-BLAS instancing: ``blas_list`` holds (p0, e1, e2, tri_ids)
    soups in local space, ``instances`` (blas_index, to_world (3, 4)).
    Super boxes are world-space; child boxes and cluster rows are shared
    local-space tables reached through ``sup_blas``."""
    blas_data = []
    for (p0, e1, e2, tri_ids) in blas_list:
        p0 = np.asarray(p0, np.float32)
        e1 = np.asarray(e1, np.float32)
        e2 = np.asarray(e2, np.float32)
        soup = np.concatenate([p0, e1, e2], axis=1)
        lo, hi = bvh_mod.tri_bounds(p0, e1, e2)
        flat = bvh_mod.build_bvh_arrays(lo, hi, leaf_size=64)
        cl_lo, cl_hi, rows = _pack_leaves(
            flat, soup, None if tri_ids is None
            else np.asarray(tri_ids, np.int64))
        blas_data.append(_pack_supers(cl_lo, cl_hi, rows)[:4])

    childs = np.concatenate([b[2] for b in blas_data], axis=0)
    blocks = np.concatenate([b[3] for b in blas_data], axis=0)
    sup_off = np.cumsum([0] + [b[0].shape[0] for b in blas_data])

    all_lo, all_hi, all_inst, all_sid = [], [], [], []
    inv_list = [_identity34()]
    fwd_list = [inv_list[0].copy()]
    for (blas_i, to_world) in instances:
        M = np.asarray(to_world, np.float32).reshape(3, 4)
        R = M[:, :3]
        Rinv = np.linalg.inv(R)
        inv = np.concatenate([Rinv, (-Rinv @ M[:, 3])[:, None]], axis=1)
        if np.allclose(M, inv_list[0]):
            iid = 0
        else:
            iid = len(inv_list)
            inv_list.append(inv.astype(np.float32))
            fwd_list.append(M)
        s_lo, s_hi = blas_data[blas_i][0], blas_data[blas_i][1]
        # world AABB of a transformed box: |R| trick
        cent = (s_lo + s_hi) * 0.5 @ R.T + M[:, 3]
        ext = (s_hi - s_lo) * 0.5 @ np.abs(R).T
        all_lo.append(cent - ext)
        all_hi.append(cent + ext)
        n_s = s_lo.shape[0]
        all_inst.append(np.full(n_s, iid, np.int32))
        all_sid.append(np.arange(sup_off[blas_i], sup_off[blas_i] + n_s,
                                 dtype=np.int32))

    sup_lo = np.concatenate(all_lo).astype(np.float32)
    sup_hi = np.concatenate(all_hi).astype(np.float32)
    S = sup_lo.shape[0]
    swp_lo, swp_hi = _pad_sweep(sup_lo, sup_hi)
    S_pad = swp_lo.shape[1]
    inst_pad = np.zeros(S_pad, np.int32)
    inst_pad[:S] = np.concatenate(all_inst)
    sup_blas = np.zeros(S_pad, np.int32)
    sup_blas[:S] = np.concatenate(all_sid)
    return _from_host(dict(
        swp_lo=swp_lo, swp_hi=swp_hi, sup_inst=inst_pad, childs=childs,
        blocks=blocks, inst_inv=np.stack(inv_list),
        inst_fwd=np.stack(fwd_list), sup_blas=sup_blas, n_supers=S,
        n_tris=int(sum(len(b[0]) for b in blas_list)), indirect=True),
        device)


# ---------------------------------------------------------------------------
# plain traversal (the kernel's reference, and the CPU path)
# ---------------------------------------------------------------------------

class HierHits(NamedTuple):
    t: torch.Tensor  # (N,) f32; min(BIG, tmax) where nothing is hit
    u: torch.Tensor
    v: torch.Tensor
    prim: torch.Tensor  # (N,) int32 triangle id (0 on a miss)
    inst: torch.Tensor  # (N,) int32 instance id
    found: torch.Tensor  # (N,) bool


class HierCounts(NamedTuple):
    """Per-ray work of a traversal (int64 (N,)): super sweeps (each tests
    the ``n_supers`` super boxes), child picks (each tests the 64 child
    boxes of the current super) and clusters tested (64 triangles each)."""

    sweeps: torch.Tensor
    child_rows: torch.Tensor
    clusters: torch.Tensor


def _safe_inv(d):
    """1 / d with |d| < 1e-20 clamped to +-1e-20 (hierarchy.py:441)."""
    tiny = torch.where(d < 0, -1e-20, 1e-20)
    return 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)


def _slab(lo, hi, o, inv, tmin, tlim):
    """Entry/exit t of boxes (planes lo/hi per axis) for rays (o, inv per
    axis, broadcastable), clipped to [tmin, tlim]."""
    a0 = [(lo[k] - o[k]) * inv[k] for k in range(3)]
    a1 = [(hi[k] - o[k]) * inv[k] for k in range(3)]
    mn = [torch.minimum(a, b) for a, b in zip(a0, a1)]
    mx = [torch.maximum(a, b) for a, b in zip(a0, a1)]
    tn = torch.maximum(torch.maximum(mn[0], mn[1]),
                       torch.maximum(mn[2], tmin))
    tf = torch.minimum(torch.minimum(mx[0], mx[1]),
                       torch.minimum(mx[2], tlim))
    return tn, tf


def _lex_pick(e, gate_t, gate_c):
    """Per row, the smallest (e, column) strictly after (gate_t, gate_c)
    among entries < BIG -> (emin, column); emin = BIG when none."""
    col = torch.arange(e.shape[1], device=e.device, dtype=Int)[None]
    gated = (e > gate_t[:, None]) | ((e == gate_t[:, None])
                                     & (col > gate_c[:, None]))
    e = torch.where(gated, e, BIG)
    emin = e.amin(1)
    kk = torch.where(e == emin[:, None], col, IBIG).amin(1)
    return emin, torch.where(emin < BIG, kk, 0)


def _sweep(h: Hierarchy, o, inv, tmin, t_b, sg_t, sg_c):
    """Lex-gated nearest super of each lane: (entry t, super id)."""
    S = h.n_supers
    lo = [h.swp_lo[k, :S][None] for k in range(3)]
    hi = [h.swp_hi[k, :S][None] for k in range(3)]
    M = o[0].shape[0]
    se = torch.empty(M, dtype=Float, device=o[0].device)
    sid = torch.empty(M, dtype=Int, device=o[0].device)
    step = max(1, _CHUNK_ELEMS // max(S, 1))
    for a in range(0, M, step):
        b = min(a + step, M)
        r = slice(a, b)
        tn, tf = _slab(lo, hi, [c[r, None] for c in o],
                       [c[r, None] for c in inv], tmin[r, None],
                       t_b[r, None])
        e = torch.where((tn <= tf) & (tn < FAR), tn, BIG)
        se[r], sid[r] = _lex_pick(e, sg_t[r], sg_c[r])
    return se, sid


def _local_rays(h: Hierarchy, inst, o, d, inv):
    """Rays in their current super's instance space (direction not
    renormalised, so t stays world t)."""
    if not h.instanced:
        return o, d, inv
    m = h.inst_inv[inst]  # (M, 3, 4)
    ol = [((m[:, k, 0] * o[0] + m[:, k, 1] * o[1]) + m[:, k, 2] * o[2])
          + m[:, k, 3] for k in range(3)]
    dl = [(m[:, k, 0] * d[0] + m[:, k, 1] * d[1]) + m[:, k, 2] * d[2]
          for k in range(3)]
    return ol, dl, [_safe_inv(c) for c in dl]


def _rows_at_time(h: Hierarchy, cid):
    """The geometric planes of cluster rows ``cid`` at the hierarchy's
    shutter time: ``(1 - time) * frame 0 + time * frame 1`` for a motion
    hierarchy (each product and the sum rounded to float32), frame 0
    otherwise."""
    rows = h.blocks[cid, :LEAF * 9]
    if not h.has_motion:
        return rows
    w0 = float(np.float32(1.0) - np.float32(h.time))
    return w0 * rows + h.time * h.blocks1[cid, :LEAF * 9]


def _cluster_test(row, prim_ids, ol, dl, tmin, t_b):
    """Moeller-Trumbore of each lane's ray against its (LEAF,) row, in the
    kernel's order of operations.  Returns (tnew, u, v, prim, better):
    the smallest t < t_b with the lowest slot on exact ties."""
    p = [row[:, c * LEAF:(c + 1) * LEAF] for c in range(9)]
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = p
    ox, oy, oz = (c[:, None] for c in ol)
    dx, dy, dz = (c[:, None] for c in dl)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tx = ox - p0x
    ty = oy - p0y
    tz = oz - p0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tmin[:, None]) & (t < t_b[:, None]))
    tm = torch.where(hit, t, BIG)
    tnew = tm.amin(1)
    lane = torch.arange(LEAF, device=row.device, dtype=Int)[None]
    k = torch.where(tm == tnew[:, None], lane, IBIG).amin(1)
    better = tnew < t_b
    k = torch.where(better, k, 0).long()[:, None]
    return (tnew, u.gather(1, k)[:, 0], v.gather(1, k)[:, 0],
            prim_ids.gather(1, k)[:, 0], better)


def intersect_hierarchy_plain(h: Hierarchy, o: V3, d: V3, tmin, tmax,
                              any_hit: bool = False, active=None):
    """Closest (or any) hit of SoA rays over the hierarchy.

    tmin/tmax: floats or (N,) tensors; ``active`` (N,) bool masks lanes off
    (they return no hit).  Returns (HierHits, HierCounts)."""
    comps, n, dev = _rays(o, d, tmin, tmax)
    ox, oy, oz, dx, dy, dz, tmin, tmax = comps
    inv = [_safe_inv(c) for c in (dx, dy, dz)]
    root = h.root
    tn, tf = _slab([root[0], root[1], root[2]], [root[3], root[4], root[5]],
                   [ox, oy, oz], inv, tmin, tmax)
    live = tn <= tf
    if active is not None:
        live = live & active

    t = torch.minimum(torch.full((n,), BIG, dtype=Float, device=dev), tmax)
    u = torch.zeros(n, dtype=Float, device=dev)
    v = torch.zeros(n, dtype=Float, device=dev)
    prim = torch.zeros(n, dtype=Int, device=dev)
    inst = torch.zeros(n, dtype=Int, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    counts = HierCounts(*(torch.zeros(n, dtype=torch.int64, device=dev)
                          for _ in range(3)))
    blocks_i = h.blocks.view(Int)

    # compact per-lane state of the live rays
    idx = live.nonzero()[:, 0]
    m = idx.numel()
    st = dict(
        idx=idx, o=[c[idx] for c in (ox, oy, oz)],
        d=[c[idx] for c in (dx, dy, dz)], inv=[c[idx] for c in inv],
        tmin=tmin[idx], t=t[idx], u=u[idx], v=v[idx], prim=prim[idx],
        inst=inst[idx], found=found[idx],
        sg_t=torch.full((m,), -BIG, dtype=Float, device=dev),
        sg_c=torch.full((m,), -1, dtype=Int, device=dev),
        sidc=torch.zeros(m, dtype=Int, device=dev),
        ig_t=torch.full((m,), -BIG, dtype=Float, device=dev),
        ig_c=torch.full((m,), -1, dtype=Int, device=dev),
        has=torch.zeros(m, dtype=torch.bool, device=dev))

    def retire(keep):
        """Write the lanes leaving the loop back; keep the others."""
        gone = ~keep
        gi = st["idx"][gone]
        for k, out in (("t", t), ("u", u), ("v", v), ("prim", prim),
                       ("inst", inst), ("found", found)):
            out[gi] = st[k][gone]
        for k, val in st.items():
            st[k] = ([c[keep] for c in val] if isinstance(val, list)
                     else val[keep])

    while st["idx"].numel():
        # --- super sweep for lanes without a current super ---------------
        need = ~st["has"]
        if bool(need.any()):
            ni = need.nonzero()[:, 0]
            se, sid = _sweep(h, [c[ni] for c in st["o"]],
                             [c[ni] for c in st["inv"]], st["tmin"][ni],
                             st["t"][ni], st["sg_t"][ni], st["sg_c"][ni])
            counts.sweeps.index_add_(0, st["idx"][ni],
                                     torch.ones_like(ni, dtype=torch.int64))
            got = se < BIG
            gi = ni[got]
            st["sg_t"][gi] = se[got]
            st["sg_c"][gi] = sid[got]
            st["sidc"][gi] = sid[got]
            st["ig_t"][gi] = -BIG
            st["ig_c"][gi] = -1
            st["has"][gi] = True
            if not bool(got.all()):
                retire(st["has"])
                if not st["idx"].numel():
                    break

        # --- nearest unvisited child of the current super -----------------
        sidc = st["sidc"]
        inst_l = (h.sup_inst[sidc] if h.instanced
                  else torch.zeros_like(sidc))
        ol, dl, il = _local_rays(h, inst_l, st["o"], st["d"], st["inv"])
        base = h.sup_blas[sidc] if h.indirect else sidc
        crow = h.childs[base]
        planes = [crow[:, c * SUP:(c + 1) * SUP] for c in range(6)]
        ctn, ctf = _slab(planes[:3], planes[3:], [c[:, None] for c in ol],
                         [c[:, None] for c in il], st["tmin"][:, None],
                         st["t"][:, None])
        e = torch.where((ctn <= ctf) & (ctn < FAR)
                        & (ctn <= st["t"][:, None]), ctn, BIG)
        emin, kk = _lex_pick(e, st["ig_t"], st["ig_c"])
        counts.child_rows.index_add_(
            0, st["idx"], torch.ones_like(st["idx"], dtype=torch.int64))
        ihas = emin < BIG
        st["has"] = ihas

        # --- one cluster test per lane that has a child -------------------
        ci = ihas.nonzero()[:, 0]
        if ci.numel():
            st["ig_t"][ci] = emin[ci]
            st["ig_c"][ci] = kk[ci]
            cid = (base[ci] * SUP + kk[ci]).long()
            counts.clusters.index_add_(
                0, st["idx"][ci], torch.ones_like(ci, dtype=torch.int64))
            tnew, un, vn, pn, better = _cluster_test(
                _rows_at_time(h, cid), blocks_i[cid, LEAF * 9:],
                [c[ci] for c in ol], [c[ci] for c in dl], st["tmin"][ci],
                st["t"][ci])
            bi = ci[better]
            st["t"][bi] = tnew[better]
            st["u"][bi] = un[better]
            st["v"][bi] = vn[better]
            st["prim"][bi] = pn[better]
            st["inst"][bi] = inst_l[bi]
            st["found"][bi] = True
        if any_hit and bool(st["found"].any()):
            retire(~st["found"])

    return HierHits(t, u, v, prim, inst, found), counts
