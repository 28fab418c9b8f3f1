"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
GPU).  Run on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Kernels against their plain PyTorch versions on the same card tensors, and
the Cornell render on the card against the CPU render.
"""
import numpy as np
import pytest
import torch

from mitsuba_im_tpu_torch.accel import cuda_intersect as ci
from mitsuba_im_tpu_torch.core.v3 import V3
from mitsuba_im_tpu_torch.film.film import develop
from mitsuba_im_tpu_torch.render.job import render_film
from mitsuba_im_tpu_torch.scenes import tiny_cornell

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rays(gen, n, dev):
    o = torch.rand(n, 3, generator=gen, device=dev) * 3.0 - 1.5
    d = torch.randn(n, 3, generator=gen, device=dev)
    d = d / d.norm(dim=1, keepdim=True)
    return V3.from_array(o.contiguous()), V3.from_array(d.contiguous())


@pytest.mark.parametrize("T", [1, 12, 333, 512])
def test_kernels_match_plain_versions(cuda, T):
    gen = torch.Generator(device=cuda).manual_seed(T)
    tris = [torch.rand(T, 3, generator=gen, device=cuda) * s - s / 2
            for s in (2.0, 0.6, 0.6)]
    n = 100_003  # ragged last block
    o, d = _rays(gen, n, cuda)
    tmax = torch.rand(n, generator=gen, device=cuda) * 3.0
    ci.reset_launch_counts()
    k = ci.closest_tris_v(*tris, o, d, 1e-4, 1e30)
    p = ci.closest_tris_plain(*tris, o, d, 1e-4, 1e30)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    kb = ci.anyhit_tris_v(*tris, o, d, 1e-4, tmax)
    assert torch.equal(kb, ci.anyhit_tris_plain(*tris, o, d, 1e-4, tmax))
    assert (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches) == (1, 1)


def test_cornell_render_card_vs_cpu(cuda):
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene, settings = tiny_cornell(dev)
        settings.integrator_props = dict(max_depth=5)
        ci.reset_launch_counts()
        imgs.append(develop(render_film(scene, settings, spp=2)).cpu().numpy())
        if dev.type == "cuda":
            assert ci.closest_tris_v.launches == 2 * 5
            assert ci.anyhit_tris_v.launches == 2 * 4
    a, b = (im.sum(-1).ravel() for im in imgs)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2 * np.abs(b).mean())
    assert np.quantile(rel, 0.999) < 1e-3 and (rel > 1e-3).mean() < 2e-3
