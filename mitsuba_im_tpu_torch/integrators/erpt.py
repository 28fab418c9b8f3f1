"""Energy redistribution path tracing (``mitsuba_im_tpu/integrators/erpt.py``;
Cline et al. 2005, the reference Mitsuba's ``erpt``).

Each pass draws one seed path a pixel (a fresh primary-sample table of
every chain, exactly distributed), then runs ``chain_length`` lockstep
Metropolis steps of small perturbations from each seed
(``pssmlt._mutate_small``), every step depositing

    (1 - a) e_d C_cur / I_cur   at the current state's pixel
  +      a  e_d C_prop / I_prop at the proposed state's pixel

with e_d = I_seed / chain_length, so that each chain deposits its seed's
luminance and no global normalization is needed.  With ``bidirectional``
the seeds and states go through the splat sampler
(``bidir/pathsampler.py``).  The image is the deposits over the passes.

The factory's ``numChains`` is recorded and, as in the reference, unused:
a pass runs one chain a pixel (ROADMAP C23).  The splats go through
``pssmlt._splat_px`` (``index_put_`` with accumulate, the box splat's
deviation); the subsurface and MASK/BLEND observations of ``pssmlt.py``
(ROADMAP C19, C20) hold here too.
"""
from __future__ import annotations

import torch

from ..core.types import Float
from .pssmlt import (MASK32, PSSMLTConfig, _accept_prob, _draw_table, _eval,
                     _mutate_small, _n_blocks, _splat_px)


def erpt_pass(scene, img: torch.Tensor, pass_idx: int, seed: int, *,
              cfg: PSSMLTConfig, width: int, height: int,
              chain_length: int) -> torch.Tensor:
    """One seed a chain (``cfg.n_chains`` of them) and its
    ``chain_length``-step redistribution chain, deposited into ``img``."""
    n_blocks = _n_blocks(cfg)
    chain = torch.arange(cfg.n_chains, dtype=torch.int64, device=img.device)
    # the seeds: ordinary path samples
    table = _draw_table(chain, pass_idx, seed, n_blocks, 0)
    pos, color, I = _eval(scene, table, cfg, width, height)
    e_d = I / float(chain_length)  # the deposit of a step
    for i in range(chain_length):
        t = (int(pass_idx) * 0x10001 + i) & MASK32
        xi = _draw_table(chain, t, seed, n_blocks, 2)
        xi_sign = _draw_table(chain, t, seed, n_blocks, 3)
        u_misc = _draw_table(chain, t, seed, 1, 4)[:, 0, :]
        prop = _mutate_small(table, xi, xi_sign, cfg.s1, cfg.s2)
        pos_p, color_p, I_p = _eval(scene, prop, cfg, width, height)
        a = _accept_prob(I, I_p)
        w_cur = torch.where(I > 0, (1.0 - a) * e_d / torch.clamp_min(I, 1e-30),
                            0.0)
        w_prop = torch.where(I_p > 0, a * e_d / torch.clamp_min(I_p, 1e-30),
                             0.0)
        img = _splat_px(img, pos, color, w_cur)
        img = _splat_px(img, pos_p, color_p, w_prop)
        accept = u_misc[:, 1] < a
        table = torch.where(accept[:, None, None], prop, table)
        pos = torch.where(accept[:, None, None], pos_p, pos)
        color = torch.where(accept[:, None, None], color_p, color)
        I = torch.where(accept, I_p, I)
    return img


def render_erpt(scene, settings, spp: int | None = None,
                progress_cb=None) -> torch.Tensor:
    """The ERPT image (H, W, 3) on the scene's device: ``spp`` passes of
    one seed a pixel (``max_depth`` -1 means 8; ``chain_length`` 100;
    unidirectional unless ``bidirectional``); ``progress_cb(done, spp,
    img)`` runs after each pass."""
    ip = settings.integrator_props
    md = ip.get("max_depth", -1)
    W, H = settings.width, settings.height
    spp = spp if spp is not None else settings.spp
    chain_length = int(ip.get("chain_length", 100))
    cfg = PSSMLTConfig(
        max_depth=md if md > 0 else 8,
        rr_depth=ip.get("rr_depth", 5),
        n_chains=W * H,
        bidirectional=ip.get("bidirectional", False),
        media_blocks=bool(scene.media.any),
    )
    seed = int(settings.seed) & MASK32
    img = torch.zeros((H, W, 3), dtype=Float, device=scene.device)
    with torch.no_grad():
        for p in range(spp):
            img = erpt_pass(scene, img, p + 1, seed, cfg=cfg, width=W,
                            height=H, chain_length=chain_length)
            if progress_cb is not None:
                progress_cb(p + 1, spp, img)
    # each pass deposits the seeds' luminance; the mean over passes
    return img * (W * H / (spp * W * H))
