"""Differentiable rendering: scene-parameter gradients and the inverse
rendering loop (``mitsuba_im_tpu/diff/optimize.py``).

The wavefront estimator is differentiable in reverse mode with respect to
the BSDF reflectances and roughness (every ported family's), the texture
atlas (every bitmap's texels) and the emitter radiance (an environment
map's row is its scale); the bounce
loop replays under ``torch.utils.checkpoint`` (``PathConfig.remat``), so
the backward pass re-runs the wavefront with the same RNG counters (path
replay) instead of keeping every bounce's state.  Discrete decisions (lobe,
emitter, roulette) and visibility are not differentiated: the gradient is
the interior derivative of the continuous weights, as in the reference.

Parameters are substituted into the frozen scene tables with
``dataclasses.replace``.  ``render_rays`` traces without ray
differentials, as the reference's does, so bitmaps are looked up
unfiltered there and the atlas gradient reaches base-level texels only.
The sampler is the settings' kind with ``settings.spp`` (the reference's
``render_rays``; ``render_film`` passes the call's ``spp`` instead).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng as mrng
from ..core.types import Float
from ..integrators.path import PathConfig, path_li_v
from ..render.job import RenderSettings, sampler_kind
from ..scene.scene import Scene
from ..sensor.table import sample_ray_v


def _set_bsdfs(scene: Scene, **cols) -> Scene:
    return dataclasses.replace(
        scene, bsdfs=dataclasses.replace(scene.bsdfs, **cols))


# differentiable parameter slots: label -> (getter, setter)
PARAM_SLOTS = {
    "bsdf.refl": (lambda s: s.bsdfs.refl,
                  lambda s, v: _set_bsdfs(s, refl=v)),
    "bsdf.spec": (lambda s: s.bsdfs.spec,
                  lambda s, v: _set_bsdfs(s, spec=v)),
    "bsdf.alpha": (
        lambda s: torch.stack([s.bsdfs.alpha_u, s.bsdfs.alpha_v], -1),
        lambda s, v: _set_bsdfs(s, alpha_u=v[..., 0], alpha_v=v[..., 1])),
    "emitter.radiance": (
        lambda s: s.emitters.radiance,
        lambda s, v: dataclasses.replace(
            s, emitters=dataclasses.replace(s.emitters, radiance=v))),
    "texture.atlas": (
        lambda s: s.textures.atlas,
        lambda s, v: dataclasses.replace(
            s, textures=dataclasses.replace(s.textures, atlas=v))),
}


def get_params(scene: Scene, labels) -> dict:
    return {label: PARAM_SLOTS[label][0](scene) for label in labels}


def set_params(scene: Scene, params: dict) -> Scene:
    for label, value in params.items():
        scene = PARAM_SLOTS[label][1](scene, value)
    return scene


def render_rays(scene: Scene, settings: RenderSettings, cfg: PathConfig,
                pix: torch.Tensor, sample_idx, seed) -> torch.Tensor:
    """Differentiable per-pixel radiance estimate (N, 3) for a batch of
    pixel indices: one sample each, the reference's ``render_rays``."""
    W, H = settings.width, settings.height
    sampler = mrng.make_sampler_v(pix, sample_idx, seed,
                                  kind=sampler_kind(settings),
                                  spp=settings.spp)
    sampler, blk0 = mrng.next_block4_v(sampler)
    px = (pix % W).to(Float) + blk0[0]
    py = (pix // W).to(Float) + blk0[1]
    o, d, w = sample_ray_v(scene.sensor, px / W, py / H, blk0[2], blk0[3])
    li, _ = path_li_v(scene, sampler, o, d, cfg)
    return torch.stack(list(li), -1) * w[:, None]


def _pixels(settings: RenderSettings, scene: Scene) -> torch.Tensor:
    return torch.arange(settings.width * settings.height, dtype=torch.int64,
                        device=scene.device)


def make_loss_fn(scene: Scene, settings: RenderSettings, cfg: PathConfig,
                 target: torch.Tensor, labels):
    """MSE between a one-sample rendered estimate and the target image."""
    pix = _pixels(settings, scene)
    tgt = target.reshape(-1, 3)

    def loss(params, sample_idx, seed):
        li = render_rays(set_params(scene, params), settings, cfg, pix,
                         sample_idx, seed)
        return torch.mean((li - tgt) ** 2)

    return loss


class OptState(NamedTuple):
    params: dict  # label -> leaf tensor (requires grad)
    opt_state: torch.optim.Optimizer
    step: int


def make_train_step(scene: Scene, settings: RenderSettings, cfg: PathConfig,
                    target: torch.Tensor, labels, lr: float = 2e-2):
    """Adam steps over the selected scene parameters: (init, step), where
    ``step(state, seed) -> (state, loss)`` renders the state's sample index,
    takes one ``torch.optim.Adam`` step (the reference's ``optax.adam``)
    and clips every parameter to [0, 1e4]."""
    loss_fn = make_loss_fn(scene, settings, cfg, target, labels)

    def init():
        params = {k: p.detach().clone().requires_grad_(True)
                  for k, p in get_params(scene, labels).items()}
        return OptState(params, torch.optim.Adam(params.values(), lr=lr), 0)

    def step(state: OptState, seed):
        opt = state.opt_state
        opt.zero_grad()
        loss = loss_fn(state.params, state.step, seed)
        loss.backward()
        opt.step()
        with torch.no_grad():
            for p in state.params.values():
                p.clamp_(0.0, 1e4)
        return OptState(state.params, opt, state.step + 1), loss.detach()

    return init, step


def _mean_image(scene, settings, cfg, n_samples, seed):
    pix = _pixels(settings, scene)
    acc = 0.0
    for s in range(n_samples):
        acc = acc + render_rays(scene, settings, cfg, pix, s, seed)
    return acc / n_samples


def finite_difference_grad(scene: Scene, settings: RenderSettings,
                           cfg: PathConfig, label: str, index, eps: float,
                           n_samples: int = 32, seed: int = 0):
    """Central finite difference of the mean image with respect to one
    parameter entry: (H*W, 3), the reference's FD-vs-AD harness."""
    getter, setter = PARAM_SLOTS[label]
    base = getter(scene).detach()
    bump = torch.zeros_like(base)
    bump[index] = eps
    with torch.no_grad():
        img_p = _mean_image(setter(scene, base + bump), settings, cfg,
                            n_samples, seed)
        img_m = _mean_image(setter(scene, base - bump), settings, cfg,
                            n_samples, seed)
    return (img_p - img_m) / (2 * eps)


def autodiff_image_grad(scene: Scene, settings: RenderSettings,
                        cfg: PathConfig, label: str, index,
                        n_samples: int = 32, seed: int = 0) -> float:
    """d(sum of the image)/d(param[index]) by reverse mode, averaged over
    the finite-difference harness's samples, so the two compare directly."""
    getter, setter = PARAM_SLOTS[label]
    base = getter(scene).detach()
    # a tuple indexes the parameter, an int its flattened entries
    pos = torch.tensor([int(np.ravel_multi_index(index, base.shape))
                        if isinstance(index, tuple) else int(index)],
                       device=base.device)
    flat = base.reshape(-1)
    theta = flat[pos].clone().requires_grad_(True)
    pix = _pixels(settings, scene)
    g = 0.0
    for s in range(n_samples):
        value = flat.index_put((pos,), theta).reshape(base.shape)
        li = render_rays(setter(scene, value), settings, cfg, pix, s, seed)
        g = g + torch.autograd.grad(li.sum(), theta)[0].item()
    return g / n_samples
