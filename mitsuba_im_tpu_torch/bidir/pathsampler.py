"""The unified path-space splat sampler
(``mitsuba_im_tpu/bidir/pathsampler.py``, the reference Mitsuba's
``PathSampler::sampleSplats``, pathsampler.h:121): one primary-sample
state gives eye and light subpaths, every (s, t) strategy with its MIS
weight, and the list of weighted splats, the t = 1 light-tracing ones at
their own film positions.

The state is the (N, B, 4) primary-sample table of a lockstep chain
ensemble, read by the sampler's table mode (``core/rng.py``); one call
evaluates every strategy of every chain through the port's
``integrators/bdpt.py::bdpt_sample``.  The Metropolis target is the summed
luminance of all splats (``SplatList::luminance``, pathsampler.h:173).
``bdpt_sample`` never calls the subsurface estimators, so a subsurface
shape adds no light here (ROADMAP C20).
"""
from __future__ import annotations

import torch

from ..core import rng as mrng
from ..core.types import Float
from ..sensor.table import sample_ray_v


def n_blocks_bidir(max_depth: int, has_media: bool = False) -> int:
    """Blocks of 4 dimensions one evaluation draws: 1 camera block, one a
    step of the eye walk (max_depth steps), 2 for the light's origin, one
    a step of the light walk (max_depth - 1) and one a next-event
    estimation from each eye vertex that fits the depth (max_depth - 1),
    in ``bdpt_sample``'s order; media add a free-flight block to every
    walk step."""
    per_step = 2 if has_media else 1
    return (1 + per_step * max_depth + 2
            + per_step * max(max_depth - 1, 0) + max(max_depth - 1, 0))


def n_light_splats(max_depth: int) -> int:
    """The t = 1 (light tracing) strategies ``bdpt_sample`` emits."""
    return max(max_depth - 1, 0)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec. 709 luminance of (..., 3) (spectrum.h getLuminance)."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 \
        + rgb[..., 2] * 0.072169


def sample_splats(scene, table: torch.Tensor, max_depth: int, width: int,
                  height: int):
    """Every strategy of a batch of primary-sample tables (N, B, 4), B >=
    ``n_blocks_bidir(max_depth, scene.media.any)``.

    Returns (pos (N, 2) the eye pixel's film coordinates, li (N, 3) its
    radiance, splat_pos (K, N, 2) the light-tracing splats' film
    coordinates, splat_val (K, N, 3), I (N,) the summed luminance of all
    splats)."""
    from ..integrators.bdpt import _finite, bdpt_sample

    n = table.shape[0]
    chain = torch.arange(n, dtype=torch.int64, device=table.device)
    s = mrng.make_sampler_v(chain, 0, 0).replace(table=table)
    s, blk0 = mrng.next_block4_v(s)
    o, d, w_sensor = sample_ray_v(scene.sensor, blk0[0], blk0[1], blk0[2],
                                  blk0[3])
    li, splats = bdpt_sample(scene, s, o, d, max_depth)
    li = _finite(torch.stack(list(li), dim=-1)) * w_sensor[:, None]
    wh = torch.tensor([width, height], dtype=Float, device=table.device)
    pos = torch.stack([blk0[0], blk0[1]], dim=-1) * wh
    if splats:
        s_pos = torch.stack([torch.stack([u, vv], dim=-1)
                             for u, vv, _ in splats]) * wh
        s_val = _finite(torch.stack([torch.stack(list(c), dim=-1)
                                     for _, _, c in splats]))
    else:
        s_pos = torch.zeros((0, n, 2), dtype=Float, device=table.device)
        s_val = torch.zeros((0, n, 3), dtype=Float, device=table.device)
    I = luminance(li)
    if s_val.shape[0]:
        I = I + luminance(s_val).sum(dim=0)
    return pos, li, s_pos, s_val, I
