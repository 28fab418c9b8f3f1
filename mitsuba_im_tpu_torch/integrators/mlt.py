"""Veach-style Metropolis light transport over the replayable primary-sample
space (``mitsuba_im_tpu/integrators/mlt.py``; the reference Mitsuba's
``mlt`` with its mutators ``mut_lens``, ``mut_caustic``, ``mut_mchain``,
``mut_manifold`` and ``mut_bidir``).

A state is a chain's primary-sample table, which the sampler's table mode
replays into the same path (``integrators/pssmlt.py``), so "keep part of
the path" is "keep those blocks".  Each step picks one mutation a chain by
its first selection uniform (:func:`mlt_step_tables`):

- the bidirectional mutation, a fresh table (the large step, ``p_large``);
- the lens perturbation (``p_lens``): an exponential screen-space step of
  the camera block, r2 exp(-log(r2 / r1) u), every other block kept;
- the caustic perturbation (``p_caustic``): Kelemen's small step of the
  light subpath's blocks, the eye path kept (bidirectionally), or of the
  last bounce's blocks (the unidirectional replay);
- the multi-chain perturbation (``p_mchain``): the lens step and the small
  step of every block from a random bounce on;
- the manifold perturbation (``p_manifold``, bidirectional only,
  :func:`_manifold_tables`): the vertex after a specular chain moves on
  its tangent plane, the chain is re-solved by the Newton walk
  (``bidir/manifold.py``), and the move is written back into the diffuse
  vertex's BSDF-sample uniforms, with D(x') / D(x) in the acceptance;
- otherwise Kelemen's small step of every block.

Every state is evaluated through ``pssmlt._eval`` (bidirectionally every
BDPT strategy, ``bidir/pathsampler.py``), accepted with min(1, corr I'/I)
and both states splat, as in pssmlt.

Deviations from the reference, deliberate:

- **The concentric inverse (ROADMAP C3).**  The reference writes the
  manifold move back through the inverse of the polar cosine warp (u1 =
  x^2 + y^2, u2 = atan2(y, x) / 2 pi), but the diffuse sample it replays
  is the concentric map, so its replayed proposal is not the move the
  walk solved.  The port writes the inverse of what
  ``bsdf/eval.py::bsdf_sample_v`` does for the lane
  (``core/v3.py::uniform_disk_concentric_to_square`` of the local
  direction's x and y, a two-sided back face's flipped frame included);
  the replay then reaches the solved vertex.  The density D and the ratio
  are the reference's: the concentric map preserves area, so the table
  coordinates' density is cos / pi either way.
- **The manifold proposal runs only on the lanes that select it.**  The
  reference computes it for every chain every step and keeps it on the
  ``p_manifold`` share; the port gathers those lanes, runs
  :func:`_manifold_tables` on them (with their own chain indices), and
  scatters the proposal and the factor back.  Each lane's eye walk,
  Newton walk and determinants depend on that lane alone, so the kept
  values are the reference's computation; only thrown-away proposals are
  skipped.  For the same reason a chain's Newton walk and determinants
  run only on the lanes that match its pattern (the others' proposal is
  their own table), and the patterns of one chain length walk as one
  batch (the determinants at both states in one call), where the
  reference walks each pattern on every lane: at most 68 re-projection
  traces a step at depth 5 instead of 89 (the eye walk's 5 and 21 K for
  each chain length K that some lane matches), the same values up to the
  batched solve's arithmetic.

Reference observations copied for parity (ROADMAP C25-C28): the factory
reads neither ``bidirectional`` nor the manifold's weight and step, so a
scene file's MLT is bidirectional with ``p_manifold`` 0.05; the patterns
with a specular prefix (i0 = 2) rarely match and seldom converge.  The
splats are ``pssmlt._splat_px``'s (``index_put_`` with accumulate).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..bsdf import common as bc
from ..core import rng as mrng
from ..core import v3 as v
from ..core.types import Float, Int
from ..sensor.table import sample_ray_v
from .bdpt import _dir, camera_pdf_dir, random_walk
from .pssmlt import (MASK32, PSSMLTConfig, _draw_table, _eval, _mutate_small,
                     _n_blocks, _splat_px, pssmlt_init)
from ..bidir import manifold as mf

# the chain patterns of the manifold perturbation: (i0, K) = the diffuse
# vertex a = eye_vs[i0] after i0 specular vertices, then K specular
# vertices, then the non-specular vertex b
PATTERNS = ((0, 1), (0, 2), (2, 1), (2, 2))


@dataclasses.dataclass(frozen=True)
class MLTConfig:
    max_depth: int = 8
    rr_depth: int = 5
    n_chains: int = 8192
    burn_in: int = 64
    p_large: float = 0.1  # the bidirectional mutation
    p_lens: float = 0.35
    p_caustic: float = 0.2
    p_mchain: float = 0.15
    # the manifold perturbation (bidirectional only)
    p_manifold: float = 0.05
    # its tangent step as a share of the scene's bounding radius
    manifold_sigma: float = 2e-4
    # Kelemen's small step, the rest of the mixture
    s1: float = 1.0 / 1024.0
    s2: float = 1.0 / 64.0
    # the lens step's radii in film units (mut_lens.h's r1, r2)
    lens_r1: float = 0.0002
    lens_r2: float = 0.05
    # separateDirect: depth <= 2 by plain sampling, MCMC on the rest
    separate_direct: bool = True
    direct_samples: int = 16
    # every BDPT strategy through the splat sampler (pathsampler.h:121)
    bidirectional: bool = True
    # the scene has media: each bidirectional walk step draws one more block
    media_blocks: bool = False


def _pss_cfg(cfg: MLTConfig) -> PSSMLTConfig:
    return PSSMLTConfig(max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
                        p_large=cfg.p_large, n_chains=cfg.n_chains,
                        burn_in=cfg.burn_in, s1=cfg.s1, s2=cfg.s2,
                        separate_direct=cfg.separate_direct,
                        bidirectional=cfg.bidirectional,
                        media_blocks=cfg.media_blocks)


def _lens_step(u_img: torch.Tensor, r, phi) -> torch.Tensor:
    """An exponential screen step of u_img (N, 2) in [0, 1)^2, wrapped."""
    up = u_img + torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)
    return up - torch.floor(up)


def _arr(x: v.V3) -> torch.Tensor:
    return torch.stack(list(x), -1)


def eye_walk(scene, table: torch.Tensor, cfg: MLTConfig,
             chain: torch.Tensor | None = None) -> list:
    """The eye subpath of tables (N, B, 4) in the bidirectional layout:
    bdpt's ``random_walk`` of ``cfg.max_depth`` steps from the camera block,
    on the sampler's table mode (``chain``: the lanes' chain indices, the
    words past the table's end; default 0..N-1)."""
    n = table.shape[0]
    dev = table.device
    if chain is None:
        chain = torch.arange(n, dtype=torch.int64, device=dev)
    s = mrng.make_sampler_v(chain, 0, 0).replace(table=table)
    s, blk0 = mrng.next_block4_v(s)
    o, d, _w = sample_ray_v(scene.sensor, *blk0)
    mid0 = (torch.full((n,), scene.camera_medium, dtype=Int, device=dev)
            if scene.media.any else None)
    eye_vs, _s, _esc, _ = random_walk(
        scene, s, o, d, v.ones((n,), dev), camera_pdf_dir(scene, d),
        cfg.max_depth, o, d, medium0=mid0)
    return eye_vs


def pattern_mask(eye_vs: list, i0: int, K: int) -> torch.Tensor:
    """The lanes whose eye path has the manifold pattern (i0, K): the i0
    vertices before a = eye_vs[i0] specular, a diffuse (the inverse warp is
    exact for the cosine lobe alone), the K vertices after it specular,
    and b = eye_vs[i0 + K + 1] valid and not specular."""
    a, b = eye_vs[i0], eye_vs[i0 + K + 1]
    pat = a["valid"] & ~a["delta"] & b["valid"] & ~b["delta"]
    for j in list(range(i0)) + list(range(i0 + 1, i0 + 1 + K)):
        pat = pat & eye_vs[j]["valid"] & eye_vs[j]["delta"]
    return pat & (a["bp"].type == bc.DIFFUSE)


def box_muller(u: torch.Tensor):
    """Two standard normals (N,) each from the uniforms u (N, 2)."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u[:, 0], 1e-12)))
    return (r * torch.cos(2.0 * math.pi * u[:, 1]),
            r * torch.sin(2.0 * math.pi * u[:, 1]))


# the fields of a pattern's chain (:func:`pattern_chain`)
CHAIN = ("a_p", "b_p", "tb", "bb", "b_new", "pos", "nrm", "eta")


def pattern_chain(eye_vs: list, i0: int, K: int, g1, g2, sigma) -> dict:
    """Pattern (i0, K)'s chain on every lane of the eye walk: a's and b's
    points a_p, b_p (N, 3), the tangent frame tb, bb at b, b_new = b moved
    by sigma (g1 tb + g2 bb), the K specular vertices' points and normals
    pos, nrm (N, K, 3) and their relative indices eta (N, K): 1 for a
    reflection, eta_s by the crossing's side for a refraction, from the
    replayed geometry."""
    ch = eye_vs[i0 + 1:i0 + 1 + K]
    b = eye_vs[i0 + K + 1]
    etas = []
    for i, c in enumerate(ch):
        nxt = b["p"] if i == K - 1 else ch[i + 1]["p"]
        wo_c = _dir(c["p"], nxt)
        ci = c["wi_world"].dot(c["ns"])
        co = wo_c.dot(c["ns"])
        es = torch.clamp_min(c["bp"].eta_s, 1e-3)
        etas.append(torch.where(ci * co < 0,
                                torch.where(ci > 0, es, 1.0 / es), 1.0))
    tb, bb = mf._tangent_frame(_arr(b["ns"]))
    b_p = _arr(b["p"])
    return dict(a_p=_arr(eye_vs[i0]["p"]), b_p=b_p, tb=tb, bb=bb,
                b_new=b_p + sigma * (g1[:, None] * tb + g2[:, None] * bb),
                pos=torch.stack([_arr(c["p"]) for c in ch], 1),
                nrm=torch.stack([_arr(c["ns"]) for c in ch], 1),
                eta=torch.stack(etas, 1))


def _merge(xs: list, masks: list) -> torch.Tensor:
    """xs[j] on the lanes of masks[j] (j >= 1), xs[0] elsewhere."""
    out = xs[0]
    for x, m in zip(xs[1:], masks[1:]):
        out = torch.where(m.view(-1, *[1] * (x.dim() - 1)), x, out)
    return out


def _manifold_tables(scene, table: torch.Tensor, cfg: MLTConfig,
                     u_gauss: torch.Tensor, chain: torch.Tensor | None = None,
                     info: dict | None = None):
    """The manifold perturbation of tables (N, B, 4) as an edit of their
    uniforms (``mut_manifold.cpp``), bidirectional layout only.

    The eye walk (``bdpt.py::random_walk`` on the table) gives each lane's
    vertices; a lane matches pattern (i0, K) when a = eye_vs[i0] is
    diffuse, the i0 vertices before it and the K after it are specular and
    b = eye_vs[i0 + K + 1] is not.  b moves by a Gaussian (Box-Muller of
    ``u_gauss`` (N, 2)) of sigma = ``manifold_sigma`` x the bounding radius
    on its tangent plane; the Newton walk re-solves the chain from a to the
    moved b; where it converged on the same shapes and the new direction
    at a lies in the hemisphere that a's BSDF sample gives, a's sample
    uniforms (block 1 + per_step i0 + per_step - 1, uniforms 1 and 2)
    become the concentric inverse of the new local direction (C3), and the
    acceptance factor is D(x') / D(x), D = (cos_a / pi) (cos_c0 / d^2)
    |det J| with J the manifold map's Jacobian.  Lanes that do not move
    propose their own table with factor 1.

    ``chain`` gives the lanes' chain indices (the sampler's words past the
    table's end; default 0..N-1).  ``info``, when a dict, receives per
    pattern (i0, K) the lanes that matched, those that moved and the solved
    first specular vertex (N, 3).  Returns (proposal (N, B, 4), factor
    (N,), moved (N,))."""
    n = table.shape[0]
    dev = table.device
    eye_vs = eye_walk(scene, table, cfg, chain)
    per_step = 2 if cfg.media_blocks else 1
    g1, g2 = box_muller(u_gauss)
    sigma = cfg.manifold_sigma * scene.emitters.bsphere_radius
    chains = {(i0, K): pattern_chain(eye_vs, i0, K, g1, g2, sigma)
              for i0, K in PATTERNS if i0 + K + 1 < len(eye_vs)}
    pats = {key: pattern_mask(eye_vs, *key) for key in chains}

    # the patterns of one chain length walk as one batch on the lanes that
    # match one of them (the patterns are exclusive, and each lane's walk
    # and determinants depend on that lane alone), D's determinants at both
    # states in one call; a length that no lane matches does not walk
    for K in sorted({k for _, k in chains}):
        keys = [key for key in chains if key[1] == K]
        idx = torch.nonzero(torch.stack([pats[k] for k in keys]).any(0)
                            ).squeeze(1)
        zero = torch.zeros((n,), dtype=Float, device=dev)
        got = dict(p2=torch.zeros((n, K, 3), dtype=Float, device=dev),
                   n2=torch.zeros((n, K, 3), dtype=Float, device=dev),
                   s2=torch.zeros((n, K), dtype=Int, device=dev),
                   conv=torch.zeros((n,), dtype=torch.bool, device=dev),
                   d_old=zero, d_new=zero)
        if idx.numel():
            w = {f: _merge([chains[k][f] for k in keys],
                           [pats[k] for k in keys])[idx] for f in CHAIN}
            walk = mf.manifold_walk(scene, w["a_p"], w["pos"], w["b_new"],
                                    w["eta"])
            dets = mf.manifold_map_det(
                w["a_p"].repeat(2, 1), torch.cat([w["pos"], walk[0]]),
                torch.cat([w["b_p"], w["b_new"]]),
                torch.cat([w["nrm"], walk[1]]), w["eta"].repeat(2, 1),
                (w["tb"].repeat(2, 1), w["bb"].repeat(2, 1)))
            m = idx.numel()
            got = {f: got[f].index_put((idx,), x.to(got[f].dtype))
                   for f, x in zip(got, (*walk, dets[:m], dets[m:]))}
        for key in keys:
            chains[key].update(got)

    prop = table.clone()
    corr = torch.ones((n,), dtype=Float, device=dev)
    moved = torch.zeros((n,), dtype=torch.bool, device=dev)
    for (i0, K), w in chains.items():
        blk_a = 1 + per_step * i0 + (per_step - 1)
        a = eye_vs[i0]
        ch = eye_vs[i0 + 1:i0 + 1 + K]
        pat = pats[(i0, K)]
        # the chain must stay on its shapes (a jump to another shape breaks
        # the reverse proposal)
        same = w["conv"]
        for i, c in enumerate(ch):
            same = same & (w["s2"][:, i] == c["shape"])
        first = v.V3.from_array(w["p2"][:, 0])
        wo_new = _dir(a["p"], first)
        wol = v.to_local((a["ss"], a["ts"], a["ns"]), wo_new)
        # bsdf_sample_v's two-sided flip: a back-facing lane samples the
        # mirrored hemisphere
        flip = ((a["bp"].flags & bc.FLAG_TWOSIDED) != 0) & \
            (a["wi_local"].z < 0)
        ok = pat & same & (torch.where(flip, -wol.z, wol.z) > 1e-4)
        u1, u2 = v.uniform_disk_concentric_to_square(wol.x, wol.y)

        # D at both states, the manifold map's determinants in it
        c0_p = ch[0]["p"]
        wo_old = _dir(a["p"], c0_p)
        cos_a_old = torch.abs(wo_old.dot(a["ns"]))
        cos_a_new = torch.abs(wol.z)
        d2_old = ((_arr(c0_p) - w["a_p"]) ** 2).sum(-1)
        d2_new = ((w["p2"][:, 0] - w["a_p"]) ** 2).sum(-1)
        cos_c_old = torch.abs(wo_old.dot(ch[0]["ns"]))
        cos_c_new = torch.abs(wo_new.dot(v.V3.from_array(w["n2"][:, 0])))
        D_old = cos_a_old * cos_c_old / torch.clamp_min(d2_old, 1e-12) * \
            w["d_old"]
        D_new = cos_a_new * cos_c_new / torch.clamp_min(d2_new, 1e-12) * \
            w["d_new"]
        ratio = torch.where((D_old > 1e-20) & (D_new > 1e-20),
                            D_new / torch.clamp_min(D_old, 1e-20), 0.0)
        ok = ok & (ratio > 0) & torch.isfinite(ratio)

        # the patterns are exclusive: a lane's edit is its pattern's alone
        prop[:, blk_a, 1] = torch.where(ok, u1, prop[:, blk_a, 1])
        prop[:, blk_a, 2] = torch.where(ok, u2, prop[:, blk_a, 2])
        corr = torch.where(ok, ratio, corr)
        moved = moved | ok
        if info is not None:
            info[(i0, K)] = dict(match=pat, moved=ok, first=w["p2"][:, 0])
    return prop, corr, moved


def mutation_masks(u: torch.Tensor, cfg: MLTConfig,
                   use_manifold: bool = True):
    """Each chain's mutation by its selection uniform ``u`` (N,): the masks
    (large, lens, caustic, multi-chain, manifold), in that order on [0, 1);
    the rest takes the small step."""
    p0 = cfg.p_large
    p1 = p0 + cfg.p_lens
    p2 = p1 + cfg.p_caustic
    p3 = p2 + cfg.p_mchain
    p4 = p3 + (cfg.p_manifold if use_manifold else 0.0)
    return (u < p0, (u >= p0) & (u < p1), (u >= p1) & (u < p2),
            (u >= p2) & (u < p3), (u >= p3) & (u < p4))


def mlt_step_tables(table: torch.Tensor, u_aux: torch.Tensor, cfg: MLTConfig,
                    chain: torch.Tensor, t: int, seed: int, scene=None):
    """Every chain's proposal by the mixture of mutations, picked by
    ``u_aux`` (N, 4)'s first uniform.  Returns (proposal (N, B, 4),
    is_large (N,), corr (N,)), corr the acceptance factor: 1 for the
    symmetric mutations, D(x') / D(x) for a manifold move."""
    n_blocks = _n_blocks(_pss_cfg(cfg))
    n_iters = max(cfg.max_depth - 1, 0)
    N = table.shape[0]

    fresh = _draw_table(chain, t, seed, n_blocks, 1)
    xi = _draw_table(chain, t, seed, n_blocks, 2)
    xi_sign = _draw_table(chain, t, seed, n_blocks, 3)
    small = _mutate_small(table, xi, xi_sign, cfg.s1, cfg.s2)

    use_manifold = (scene is not None and cfg.bidirectional
                    and cfg.p_manifold > 0)
    is_large, is_lens, is_caustic, is_mchain, is_manifold = mutation_masks(
        u_aux[:, 0], cfg, use_manifold)

    # the exponential radius r2 exp(-log(r2 / r1) u) (mut_lens.h)
    r = cfg.lens_r2 * torch.exp(-math.log(cfg.lens_r2 / cfg.lens_r1)
                                * u_aux[:, 1])
    phi = 2.0 * math.pi * u_aux[:, 2]
    img_new = _lens_step(table[:, 0, 0:2], r, phi)

    # lens: the camera block moves, every other block is kept
    lens_tab = table.clone()
    lens_tab[:, 0, 0:2] = img_new

    # the table's layout: [camera | 3 blocks an eye bounce] for the replay;
    # [camera | eye walk | 2 light origin | light walk | NEE] for the
    # splat sampler, a walk step per_step blocks
    if cfg.bidirectional:
        # caustic: the eye path kept, the light subpath perturbed (the PSS
        # counterpart of mut_caustic.cpp's tail perturbation)
        per_step = 2 if cfg.media_blocks else 1
        b0_caustic = 1 + per_step * cfg.max_depth
        blocks_per_bounce = per_step
    else:
        # caustic: the last bounce's three blocks perturbed
        b0_caustic = 1 + 3 * (n_iters - 1)
        blocks_per_bounce = 3

    caustic_tab = table
    if n_iters > 0:
        caustic_tab = torch.cat([table[:, :b0_caustic],
                                 small[:, b0_caustic:]], 1)

    # multi-chain: the lens step and the small step from a random bounce on
    if n_iters > 0:
        kcut = torch.clamp_max((u_aux[:, 3] * n_iters).to(torch.int64),
                               n_iters - 1)
        bcut = 1 + blocks_per_bounce * kcut  # the cut bounce's first block
        bidx = torch.arange(n_blocks, device=table.device)[None]
        mchain_tab = torch.where((bidx >= bcut[:, None])[..., None], small,
                                 table)
        mchain_tab[:, 0, 0:2] = img_new
    else:
        mchain_tab = lens_tab

    corr = torch.ones((N,), dtype=Float, device=table.device)
    prop = small
    if use_manifold:
        # only the lanes that take the manifold proposal compute it
        idx = torch.nonzero(is_manifold).squeeze(1)
        if idx.numel():
            m_tab, m_corr, _moved = _manifold_tables(
                scene, table[idx], cfg, u_aux[idx, 1:3], chain=chain[idx])
            prop = prop.index_put((idx,), m_tab)
            corr = corr.index_put((idx,), m_corr)
    prop = torch.where(is_mchain[:, None, None], mchain_tab, prop)
    prop = torch.where(is_caustic[:, None, None], caustic_tab, prop)
    prop = torch.where(is_lens[:, None, None], lens_tab, prop)
    prop = torch.where(is_large[:, None, None], fresh, prop)
    return prop, is_large, corr


def mlt_run(scene, img: torch.Tensor, state, seed: int, step0: int, *,
            cfg: MLTConfig, width: int, height: int, n_steps: int,
            accumulate: bool):
    """Advance every chain by ``n_steps`` Metropolis steps.

    state = (table (N, B, 4), pos (N, S, 2), color (N, S, 3), I (N,),
    b_sum, b_cnt), as pssmlt's; with ``accumulate`` both states splat into
    ``img`` each step.  Returns (img, state)."""
    table, pos, color, I, b_sum, b_cnt = state
    chain = torch.arange(cfg.n_chains, dtype=torch.int64,
                         device=table.device)
    pss = _pss_cfg(cfg)
    for i in range(n_steps):
        t = (int(step0) + i) & MASK32
        u_misc = _draw_table(chain, t, seed, 2, 4)
        prop, is_large, corr = mlt_step_tables(table, u_misc[:, 0], cfg,
                                               chain, t, seed, scene=scene)
        pos_p, color_p, I_p = _eval(scene, prop, pss, width, height)
        b_sum = b_sum + torch.sum(torch.where(is_large, I_p, 0.0))
        b_cnt = b_cnt + torch.sum(is_large.to(Float))
        a = torch.where(I > 0, torch.clamp_max(
            corr * I_p / torch.clamp_min(I, 1e-30), 1.0),
            torch.where(I_p > 0, 1.0, 0.0))
        if accumulate:
            w_cur = torch.where(I > 0, (1.0 - a) / torch.clamp_min(I, 1e-30),
                                0.0)
            w_prop = torch.where(I_p > 0, a / torch.clamp_min(I_p, 1e-30),
                                 0.0)
            img = _splat_px(img, pos, color, w_cur)
            img = _splat_px(img, pos_p, color_p, w_prop)
        accept = u_misc[:, 1, 0] < a
        table = torch.where(accept[:, None, None], prop, table)
        pos = torch.where(accept[:, None, None], pos_p, pos)
        color = torch.where(accept[:, None, None], color_p, color)
        I = torch.where(accept, I_p, I)
    return img, (table, pos, color, I, b_sum, b_cnt)


def mlt_config(scene, settings) -> MLTConfig:
    """The render's configuration from the settings' integrator properties
    (``max_depth`` -1 means 8); separateDirect is forced off when
    bidirectional, since the splat space already holds the depth <= 2
    strategies under MIS."""
    ip = settings.integrator_props
    md = ip.get("max_depth", -1)
    bidirectional = ip.get("bidirectional", True)
    return MLTConfig(
        max_depth=md if md > 0 else 8,
        rr_depth=ip.get("rr_depth", 5),
        n_chains=ip.get("n_chains", 8192),
        burn_in=ip.get("burn_in", 64),
        p_large=ip.get("p_large", 0.1),
        p_lens=ip.get("p_lens", 0.35),
        p_caustic=ip.get("p_caustic", 0.2),
        p_mchain=ip.get("p_mchain", 0.15),
        p_manifold=ip.get("p_manifold", 0.05),
        manifold_sigma=ip.get("manifold_sigma", 2e-4),
        separate_direct=(ip.get("separate_direct", True)
                         and not bidirectional),
        bidirectional=bidirectional,
        media_blocks=bool(scene.media.any),
        direct_samples=ip.get("direct_samples", 16),
    )


def render_mlt(scene, settings, spp: int | None = None,
               progress_cb=None) -> torch.Tensor:
    """The MLT image (H, W, 3) on the scene's device; ``spp`` counts
    mutations a pixel.  pssmlt's start (``pssmlt_init``), a burn-in of
    min(burn_in, steps / 4) steps (none up to 8 steps), then chunks of at
    most 64 accumulated steps, after each of which ``progress_cb(done,
    total, img)`` runs; scaled by b (W H) / (accumulated mutations).
    Without ``bidirectional`` the depth <= 2 light comes from a ``path``
    render of ``direct_samples`` a pixel (mlt.cpp's directSamples)."""
    cfg = mlt_config(scene, settings)
    W, H = settings.width, settings.height
    spp = spp if spp is not None else settings.spp
    n_steps = max(W * H * spp // cfg.n_chains, 1)
    seed = int(settings.seed) & MASK32
    with torch.no_grad():
        state = pssmlt_init(scene, seed, cfg=_pss_cfg(cfg), width=W,
                            height=H)
        img = torch.zeros((H, W, 3), dtype=Float, device=scene.device)
        burn = min(cfg.burn_in, n_steps // 4) if n_steps > 8 else 0
        if burn:
            img, state = mlt_run(scene, img, state, seed, 1, cfg=cfg, width=W,
                                 height=H, n_steps=burn, accumulate=False)
        chunk = max(min(n_steps - burn, 64), 1)
        done = 0
        remaining = n_steps - burn
        while done < remaining:
            k = min(chunk, remaining - done)
            img, state = mlt_run(scene, img, state, seed, 1 + burn + done,
                                 cfg=cfg, width=W, height=H, n_steps=k,
                                 accumulate=True)
            done += k
            if progress_cb is not None:
                progress_cb(done, remaining, img)
    b = float(state[4]) / max(float(state[5]), 1.0)
    out = img * (b * (W * H) / max(remaining * cfg.n_chains, 1))
    if cfg.separate_direct and cfg.direct_samples > 0:
        from ..film.film import develop
        from ..render.job import RenderSettings, render_film

        dset = RenderSettings(
            width=W, height=H, spp=cfg.direct_samples, seed=settings.seed,
            integrator="path",
            integrator_props={"max_depth": 2, "rr_depth": cfg.rr_depth},
            rfilter=settings.rfilter, rfilter_radius=settings.rfilter_radius)
        film = render_film(scene, dset, spp=cfg.direct_samples)
        out = out + develop(film)
    return out
