"""Wavefront MIS path tracer, forward (``mitsuba_im_tpu/integrators/path.py``).

Estimator parity with the reference ``path`` plugin (path.cpp:119-290):
NEE at every vertex plus BSDF sampling, both weighted with the power
heuristic, Russian roulette with eta^2 throughput scaling from ``rr_depth``
on, ``max_depth``/``hide_emitters`` semantics.  A flat SoA batch of lanes
advances through a Python loop over bounces with masked inactive lanes,
exactly as the reference's ``fori_loop`` does, so both consume the same
random numbers per lane and agree sample for sample.

Reverse mode goes through ``torch.autograd`` with path replay, as the
reference's ``jax.checkpoint`` does (path.py:227-257): with ``remat`` each
bounce (or, with ``remat_group = g > 1``, each group of ``g`` bounces, the
remainder per bounce) runs under a non-reentrant
``torch.utils.checkpoint``, so the backward pass re-runs the wavefront,
intersection kernels included, from the counter-based RNG state carried in
the bounce state instead of keeping every bounce's intermediates.
Intersections are not differentiated (see ``accel/intersect.py``);
shading recombines ``p = o + d t`` on the live rays.  Without grad mode, or
when no scene or ray tensor requires grad, nothing is checkpointed and no
graph is recorded.
Texture filtering (ray differentials) is not ported and raises; scenes with
subsurface scattering or BSDF wrappers are refused where they are built.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..core.types import EPSILON, SHADOW_EPSILON
from ..core import v3 as v
from ..core.v3 import V3, safe_div
from ..core import rng as mrng
from ..bsdf.eval import bsdf_eval_v, bsdf_pdf_v, bsdf_sample_v
from ..emitter import table as em
from ..scene.geometry import Interaction3
from ..scene.scene import Scene


@dataclasses.dataclass(frozen=True)
class PathConfig:
    max_depth: int = -1
    rr_depth: int = 5
    hide_emitters: bool = False
    depth_budget: int = 16  # cap when max_depth == -1
    # path replay under reverse mode: checkpoint each bounce (or each group
    # of remat_group bounces) and re-run it in the backward pass
    remat: bool = True
    remat_group: int = 1
    # drop depth<=2 (directly visible emitters + single-bounce direct
    # lighting): the MLT separateDirect split
    skip_direct: bool = False
    coherent: bool = True


def mi_weight(pdf_a, pdf_b):
    """Power heuristic (path.cpp:292).  Differentiated only where a2 + b2 >=
    1e-30: below, the division's derivative overflows (a tiny pdf of a
    masked lane would turn its zero cotangent into a NaN); such lanes carry
    a zero weight or a sample drawn with probability ~0."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return v.where_live(lambda a, b: safe_div(a, a + b),
                        lambda: a2 + b2 >= 1e-30, (a2, b2), (1.0, 0.0))


def path_li_v(scene: Scene, sampler: mrng.Sampler3, o: V3, d: V3,
              cfg: PathConfig, dddx: V3 | None = None,
              dddy: V3 | None = None):
    """Trace a batch of primary rays to completion.

    Returns (radiance V3 of (N,) components, sampler); the radiance carries
    the graph to every scene or ray tensor that requires grad."""
    if dddx is not None or dddy is not None:
        raise NotImplementedError(
            "ray differentials (texture filtering) are not ported yet")
    remat = (cfg.remat and torch.is_grad_enabled()
             and _requires_grad(scene, o, d))
    return _path_li_v(scene, sampler, o, d, cfg, remat)


def _requires_grad(*objs) -> bool:
    """Does a tensor in these (dataclasses and tuples of) tensors require
    grad?"""
    for x in objs:
        if isinstance(x, torch.Tensor):
            if x.requires_grad:
                return True
        elif dataclasses.is_dataclass(x):
            if _requires_grad(*(getattr(x, f.name)
                                for f in dataclasses.fields(x))):
                return True
        elif isinstance(x, tuple) and _requires_grad(*x):
            return True
    return False


def _path_li_v(scene, sampler, o, d, cfg, remat):
    n = o.x.shape[0]
    dev = o.x.device
    n_iters = max(cfg.max_depth - 1, 0) if cfg.max_depth > 0 \
        else cfg.depth_budget
    zeros = v.zeros((n,), dev)

    li = zeros
    thr = v.ones((n,), dev)

    hit = scene.ray_intersect_v(o, d, coherent=cfg.coherent)
    it = scene.interaction_v(o, d, hit)

    # directly visible emitters / environment (depth-1 contributions)
    if not cfg.hide_emitters and not cfg.skip_direct:
        env = em.eval_environment_v(scene.emitters, d)
        li = li + v.where(~it.valid, thr * env, zeros)
        eid0 = scene.emitter_at_id(it.shape)
        le0 = em.emitted_radiance_v(scene.emitters, eid0, it.ns, -d)
        li = li + v.where(it.valid, thr * le0, zeros)

    state = dict(
        li=li, thr=thr, eta=torch.ones((n,), device=dev), active=it.valid,
        scattered=torch.zeros((n,), dtype=torch.bool, device=dev),
        p=it.p, ns=it.ns, ng=it.ng, ss=it.ss, ts=it.ts_,
        uv_u=it.uv_u, uv_v=it.uv_v,
        shape=it.shape, wi_local=it.wi_local, d_world=d,
        sampler=sampler,
    )
    del hit, it

    def bounce(depth_idx, st, skip_first=False):
        """One NEE + BSDF-extension step at the current vertex.
        ``skip_first`` marks the peeled first bounce under ``skip_direct``:
        its depth-2 contributions are dropped."""
        s = st["sampler"]
        frame = (st["ss"], st["ts"], st["ns"])
        act = st["active"]
        bparams = scene.bsdf_at_v(_fake_it_v(st))

        # --- next-event estimation (sampleEmitterDirect, path.cpp:176) ----
        s, nee_blk = mrng.next_block4_v(s)
        ds = em.sample_direct_v(scene.emitters, scene.geom, st["p"],
                                nee_blk[0], nee_blk[1], nee_blk[2])
        wo_local_nee = v.to_local(frame, ds.d)
        f_nee = bsdf_eval_v(bparams, st["wi_local"], wo_local_nee)
        pdf_bsdf_nee = bsdf_pdf_v(bparams, st["wi_local"], wo_local_nee)
        can_nee = act & (ds.pdf > 0) & (f_nee.sum() > 0)
        occ = scene.occluded_v(st["p"], ds.d, EPSILON,
                               ds.dist * (1.0 - SHADOW_EPSILON),
                               active=can_nee)
        w_nee = torch.where(ds.delta, 1.0, mi_weight(ds.pdf, pdf_bsdf_nee))
        contrib = st["thr"] * ds.value * f_nee * safe_div(w_nee, ds.pdf)
        keep_nee = can_nee & ~occ
        if skip_first:
            keep_nee = torch.zeros_like(keep_nee)
        st_li = st["li"] + v.where(keep_nee, contrib, zeros)

        # --- BSDF sampling (path.cpp:211) ---------------------------------
        s, bsdf_blk = mrng.next_block4_v(s)
        bs = bsdf_sample_v(bparams, st["wi_local"], bsdf_blk[0],
                           bsdf_blk[1], bsdf_blk[2])
        wo_world = v.to_world(frame, bs.wo)
        thr_new = st["thr"] * bs.weight
        act2 = act & ~(thr_new.sum() <= 0)
        scattered = st["scattered"] | (act & ~bs.null_passthrough)
        eta_new = st["eta"] * bs.eta

        # extend the path
        o2 = st["p"]
        hit2 = scene.ray_intersect_v(o2, wo_world, active=act2)
        it2 = scene.interaction_v(o2, wo_world, hit2)

        # emitter hit / environment with MIS (path.cpp:249-266)
        eid2 = scene.emitter_at_id(it2.shape)
        le2 = em.emitted_radiance_v(scene.emitters, eid2, it2.ns, -wo_world)
        lum_pdf_area = em.pdf_direct_area_v(scene.emitters, eid2, st["p"],
                                            it2.p, it2.ns)
        esc2 = ~it2.valid
        env_val = em.eval_environment_v(scene.emitters, wo_world)
        env_pdf = em.pdf_direct_env_v(scene.emitters, wo_world)

        lum_pdf = torch.where(bs.delta, 0.0,
                              torch.where(esc2, env_pdf, lum_pdf_area))
        w_bsdf = mi_weight(bs.pdf, lum_pdf)
        hit_val = v.where(esc2, env_val, le2)
        hide = cfg.hide_emitters & ~scattered
        keep_hit = act2 & ~hide
        if skip_first:
            keep_hit = torch.zeros_like(keep_hit)
        st_li = st_li + v.where(keep_hit, thr_new * hit_val * w_bsdf, zeros)

        act3 = act2 & it2.valid

        # --- Russian roulette (path.cpp:276-290) ---------------------------
        depth = depth_idx + 1  # reference depth counter before increment
        s, rr_blk = mrng.next_block4_v(s)
        if depth >= cfg.rr_depth:
            q = torch.clamp_max(thr_new.max_c() * eta_new * eta_new, 0.95)
            kill = rr_blk[0] >= q
            boost = 1.0 / torch.clamp_min(q, 1e-6)
            thr_new = v.where(~kill, thr_new * boost, thr_new)
            act3 = act3 & ~kill

        return dict(
            li=st_li, thr=thr_new, eta=eta_new, active=act3,
            scattered=scattered,
            p=it2.p, ns=it2.ns, ng=it2.ng, ss=it2.ss, ts=it2.ts_,
            uv_u=it2.uv_u, uv_v=it2.uv_v,
            shape=it2.shape, wi_local=it2.wi_local, d_world=wo_world,
            sampler=s,
        )

    def run(first, last, st, skip_first=False):
        """Bounces first..last-1 as one replay unit."""
        def span(st):
            for depth_idx in range(first, last):
                st = bounce(depth_idx, st, skip_first)
            return st
        if not remat:
            return span(st)
        return checkpoint(span, st, use_reentrant=False,
                          preserve_rng_state=False)

    start = 0
    if cfg.skip_direct and n_iters > 0:
        # peel the first bounce: only it drops depth-2 light
        state = run(0, 1, state, skip_first=True)
        start = 1
    g = max(int(cfg.remat_group), 1)
    if remat and g > 1:
        for _ in range((n_iters - start) // g):
            state = run(start, start + g, state)
            start += g
    for depth_idx in range(start, n_iters):
        state = run(depth_idx, depth_idx + 1, state)
    return state["li"], state["sampler"]


def _fake_it_v(st) -> Interaction3:
    """Adapter: scene.bsdf_at_v consumes an Interaction3-shaped record."""
    return Interaction3(
        p=st["p"], t=torch.zeros_like(st["uv_u"]), ng=st["ng"],
        ns=st["ns"], ss=st["ss"], ts_=st["ts"], uv_u=st["uv_u"],
        uv_v=st["uv_v"], wi_local=st["wi_local"], shape=st["shape"],
        valid=st["active"],
    )
