"""Primary-sample-space Metropolis light transport
(``mitsuba_im_tpu/integrators/pssmlt.py``; Kelemen et al. 2002, the
reference Mitsuba's ``pssmlt``).

A lockstep ensemble of chains mutates the vectors of uniforms that drive
an ordinary path tracer: each chain's state is its (B, 4) primary-sample
table, which the sampler's table mode (``core/rng.py``) feeds to the
replay, so re-evaluating a state gives the same path.  A step draws a
fresh table (the large step, probability ``p_large``) or Kelemen's
exponential perturbation of every uniform (the small step), evaluates all
proposals in one wavefront (:func:`_eval`: the path tracer, or with
``bidirectional`` every BDPT strategy through
``bidir/pathsampler.py::sample_splats``), accepts with min(1, I'/I) and
splats both states' contributions, weighted (1 - a)/I and a/I', into the
film.  The brightness b comes from a luminance pre-pass and the large
steps; the chains start from a systematic resampling of candidates by
luminance (:func:`pssmlt_init`).  The image is b (W H) / N times the
splatted sum over N accumulated mutations.

Every random draw is the counter hash of (chain, step, seed ^ stream):
:func:`_draw_table` draws a table's B blocks in one hash call, bit for bit
the reference's loop of ``next_block4``.

Reference observations (ROADMAP C19, C20): the unidirectional replay's
table holds 1 + 3 (depth - 1) blocks (:func:`_n_blocks`), which counts
neither the MASK/BLEND selection block nor the singlescatter block that
``path_li_v`` draws on each bounce of such scenes, so those draws and
every later one of the path fall past the table onto the chain's fixed
hash and are never mutated; the bidirectional sampler adds no subsurface
light.  Both are copied for parity.

Splats: the reference's ``.at[].add`` becomes ``index_put_`` with
accumulate, deterministic on the card, each chain's zero-weight splats
sent to a pixel of their own lane (``film/film.py::spread_inactive``), the
box splat's recorded deviation (ROADMAP C).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import rng as mrng
from ..core.types import Float
from ..bidir.pathsampler import luminance, n_blocks_bidir, sample_splats
from ..film.film import spread_inactive
from ..sensor.table import sample_ray_v
from .bdpt import _finite
from .path import PathConfig, path_li_v

MASK32 = mrng.MASK32


@dataclasses.dataclass(frozen=True)
class PSSMLTConfig:
    max_depth: int = 8
    rr_depth: int = 5
    p_large: float = 0.3  # pssmlt.cpp pLarge default
    n_chains: int = 8192
    burn_in: int = 32  # steps discarded per chain
    # Kelemen's mutation sizes (pssmlt_sampler.cpp: s1 = 1/1024, s2 = 1/64)
    s1: float = 1.0 / 1024.0
    s2: float = 1.0 / 64.0
    # MCMC on indirect light only, direct by plain sampling (separateDirect)
    separate_direct: bool = False
    # every BDPT strategy through the splat sampler (pathsampler.h:121)
    bidirectional: bool = False
    # the scene has media: each bidirectional walk step draws one more block
    media_blocks: bool = False


def _n_blocks(cfg: PSSMLTConfig) -> int:
    """Blocks of 4 dimensions a table holds: 1 camera + 3 a bounce for the
    unidirectional replay; the splat sampler's count bidirectionally."""
    if cfg.bidirectional:
        return n_blocks_bidir(cfg.max_depth, cfg.media_blocks)
    return 1 + 3 * max(cfg.max_depth - 1, 0)


def _path_cfg(cfg: PSSMLTConfig) -> PathConfig:
    return PathConfig(max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
                      depth_budget=cfg.max_depth,
                      skip_direct=cfg.separate_direct, coherent=False,
                      remat=False)


def _eval(scene, table: torch.Tensor, cfg: PSSMLTConfig, width: int,
          height: int):
    """Evaluate a batch of primary-sample tables (N, B, 4): (pos (N, S, 2)
    film coordinates, color (N, S, 3), I (N,) luminance) with S splats a
    state: the eye pixel alone for the replay, the eye pixel and the K
    light-tracing splats bidirectionally."""
    n = table.shape[0]
    if cfg.bidirectional:
        pos, li, s_pos, s_val, I = sample_splats(scene, table, cfg.max_depth,
                                                 width, height)
        return (torch.cat([pos[:, None], s_pos.transpose(0, 1)], dim=1),
                torch.cat([li[:, None], s_val.transpose(0, 1)], dim=1), I)
    chain = torch.arange(n, dtype=torch.int64, device=table.device)
    s = mrng.make_sampler_v(chain, 0, 0).replace(table=table)
    s, blk0 = mrng.next_block4_v(s)
    o, d, w_sensor = sample_ray_v(scene.sensor, blk0[0], blk0[1], blk0[2],
                                  blk0[3])
    li, _ = path_li_v(scene, s, o, d, _path_cfg(cfg))
    li = _finite(torch.stack(list(li), dim=-1)) * w_sensor[:, None]
    wh = torch.tensor([width, height], dtype=Float, device=table.device)
    pos = torch.stack([blk0[0], blk0[1]], dim=-1) * wh
    return pos[:, None], li[:, None], luminance(li)


def _draw_table(chain: torch.Tensor, step: int, seed: int, n_blocks: int,
                stream: int) -> torch.Tensor:
    """Fresh (N, B, 4) uniforms of (chain, step, seed ^ stream key), one
    hash a block."""
    key = (int(seed) ^ ((stream * 0x9E3779B1) & MASK32)) & MASK32
    return mrng.draw_blocks(chain, int(step) & MASK32, key, n_blocks)


def _mutate_small(u, xi, xi_sign, s1: float, s2: float):
    """Kelemen's exponential small step (pssmlt_sampler.cpp mutate())."""
    dv = s2 * torch.exp(-math.log(s2 / s1) * xi)
    up = torch.where(xi_sign < 0.5, u + dv, u - dv)
    return up - torch.floor(up)  # wrap to [0, 1)


def _splat_px(img: torch.Tensor, pos: torch.Tensor, val: torch.Tensor,
              weight: torch.Tensor) -> torch.Tensor:
    """Box splat of the chains' weighted contributions into ``img`` (H, W,
    3) in place: pos (N, S, 2), val (N, S, 3), weight (N,) shared by a
    chain's S splats."""
    H, W = img.shape[0], img.shape[1]
    px = torch.clamp(pos[..., 0].to(torch.int64), 0, W - 1)
    py = torch.clamp(pos[..., 1].to(torch.int64), 0, H - 1)
    idx = (py * W + px).reshape(-1)
    contrib = (val * weight[:, None, None]).reshape(-1, 3)
    idx = spread_inactive(idx, (contrib != 0).any(-1), W * H)
    img.view(-1, 3).index_put_((idx,), contrib, accumulate=True)
    return img


def _accept_prob(I, I_p):
    return torch.where(I > 0, torch.clamp_max(I_p / torch.clamp_min(I, 1e-30),
                                              1.0),
                       torch.where(I_p > 0, 1.0, 0.0))


def pssmlt_run(scene, img: torch.Tensor, state, seed: int, step0: int, *,
               cfg: PSSMLTConfig, width: int, height: int, n_steps: int,
               accumulate: bool):
    """Advance every chain by ``n_steps`` Metropolis steps.

    state = (table (N, B, 4), pos (N, S, 2), color (N, S, 3), I (N,),
    b_sum, b_cnt); with ``accumulate`` both states splat into ``img``
    each step.  Returns (img, state)."""
    n_blocks = _n_blocks(cfg)
    table, pos, color, I, b_sum, b_cnt = state
    chain = torch.arange(cfg.n_chains, dtype=torch.int64,
                         device=table.device)
    for i in range(n_steps):
        t = (int(step0) + i) & MASK32
        # --- propose --------------------------------------------------------
        fresh = _draw_table(chain, t, seed, n_blocks, 1)
        xi = _draw_table(chain, t, seed, n_blocks, 2)
        xi_sign = _draw_table(chain, t, seed, n_blocks, 3)
        u_misc = _draw_table(chain, t, seed, 1, 4)[:, 0, :]
        small = _mutate_small(table, xi, xi_sign, cfg.s1, cfg.s2)
        is_large = u_misc[:, 0] < cfg.p_large
        prop = torch.where(is_large[:, None, None], fresh, small)
        # --- evaluate -------------------------------------------------------
        pos_p, color_p, I_p = _eval(scene, prop, cfg, width, height)
        # the online mean brightness of the large steps
        b_sum = b_sum + torch.sum(torch.where(is_large, I_p, 0.0))
        b_cnt = b_cnt + torch.sum(is_large.to(Float))
        # --- Metropolis acceptance -----------------------------------------
        a = _accept_prob(I, I_p)
        if accumulate:
            w_cur = torch.where(I > 0, (1.0 - a) / torch.clamp_min(I, 1e-30),
                                0.0)
            w_prop = torch.where(I_p > 0, a / torch.clamp_min(I_p, 1e-30),
                                 0.0)
            img = _splat_px(img, pos, color, w_cur)
            img = _splat_px(img, pos_p, color_p, w_prop)
        accept = u_misc[:, 1] < a
        table = torch.where(accept[:, None, None], prop, table)
        pos = torch.where(accept[:, None, None], pos_p, pos)
        color = torch.where(accept[:, None, None], color_p, color)
        I = torch.where(accept, I_p, I)
    return img, (table, pos, color, I, b_sum, b_cnt)


def pssmlt_init(scene, seed: int, *, cfg: PSSMLTConfig, width: int,
                height: int, lum_rounds: int = 8):
    """The luminance pre-pass and the chains' start: ``lum_rounds`` x N
    independent paths estimate b, then the last round's candidates are
    resampled systematically by luminance (``searchsorted`` right of the
    cumulative sum) so that the chains start in the stationary
    distribution.  Returns the state of :func:`pssmlt_run`."""
    n_blocks = _n_blocks(cfg)
    n = cfg.n_chains
    dev = scene.device
    chain = torch.arange(n, dtype=torch.int64, device=dev)
    b_extra = torch.zeros((), dtype=Float, device=dev)
    for i in range(max(lum_rounds - 1, 0)):
        t = _draw_table(chain, (0xFFFF0000 + i) & MASK32, seed, n_blocks, 0)
        b_extra = b_extra + torch.sum(_eval(scene, t, cfg, width, height)[2])
    table = _draw_table(chain, 0xFFFFFFFF, seed, n_blocks, 0)
    pos, color, I = _eval(scene, table, cfg, width, height)
    b_sum = torch.sum(I) + b_extra
    b_cnt = torch.tensor(float(n * max(lum_rounds, 1)), dtype=Float,
                         device=dev)
    # systematic resampling over the ensemble
    cdf = torch.cumsum(I, dim=0)
    total = cdf[-1]
    u0 = mrng.to_unit_float(mrng.hash_u32(
        torch.tensor(int(seed) & MASK32, dtype=torch.int64, device=dev),
        0xB00F))
    targets = (torch.arange(n, dtype=Float, device=dev) + u0) / n * total
    idx = torch.clamp(torch.searchsorted(cdf, targets, right=True), 0, n - 1)
    return table[idx], pos[idx], color[idx], I[idx], b_sum, b_cnt


def pssmlt_config(scene, settings) -> PSSMLTConfig:
    """The render's configuration from the settings' integrator
    properties (``max_depth`` -1 means 8; bidirectional by default)."""
    ip = settings.integrator_props
    md = ip.get("max_depth", -1)
    return PSSMLTConfig(
        max_depth=md if md > 0 else 8,
        rr_depth=ip.get("rr_depth", 5),
        p_large=ip.get("p_large", ip.get("luminance_samples_frac", 0.3)),
        n_chains=ip.get("n_chains", 8192),
        burn_in=ip.get("burn_in", 32),
        bidirectional=ip.get("bidirectional", True),
        media_blocks=bool(scene.media.any),
    )


def render_pssmlt(scene, settings, spp: int | None = None,
                  progress_cb=None) -> torch.Tensor:
    """The PSSMLT image (H, W, 3) on the scene's device; ``spp`` counts
    mutations a pixel.  A burn-in of min(burn_in, steps / 4) steps (none
    up to 8 steps), then chunks of at most 64 accumulated steps, after each
    of which ``progress_cb(done, total, img)`` runs."""
    cfg = pssmlt_config(scene, settings)
    W, H = settings.width, settings.height
    spp = spp if spp is not None else settings.spp
    n_steps = max(W * H * spp // cfg.n_chains, 1)
    seed = int(settings.seed) & MASK32
    with torch.no_grad():
        state = pssmlt_init(scene, seed, cfg=cfg, width=W, height=H)
        img = torch.zeros((H, W, 3), dtype=Float, device=scene.device)
        burn = min(cfg.burn_in, n_steps // 4) if n_steps > 8 else 0
        if burn:
            img, state = pssmlt_run(scene, img, state, seed, 1, cfg=cfg,
                                    width=W, height=H, n_steps=burn,
                                    accumulate=False)
        chunk = max(min(n_steps - burn, 64), 1)
        done = 0
        remaining = n_steps - burn
        while done < remaining:
            k = min(chunk, remaining - done)
            img, state = pssmlt_run(scene, img, state, seed, 1 + burn + done,
                                    cfg=cfg, width=W, height=H, n_steps=k,
                                    accumulate=True)
            done += k
            if progress_cb is not None:
                progress_cb(done, remaining, img)
    b = float(state[4]) / max(float(state[5]), 1.0)
    scale = b * (W * H) / max(remaining * cfg.n_chains, 1)
    return img * scale
