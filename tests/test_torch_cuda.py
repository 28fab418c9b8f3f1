"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
GPU).  Run on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Kernels against their plain PyTorch versions on the same card tensors
(brute force, and the hierarchy traversal on plain and instanced tables),
and the Cornell and large-scene renders on the card against the CPU
renders.
"""
import numpy as np
import pytest
import torch

from mitsuba_im_tpu_torch.accel import cuda_hierarchy as ch
from mitsuba_im_tpu_torch.accel import cuda_intersect as ci
from mitsuba_im_tpu_torch.accel import hierarchy as hy
from mitsuba_im_tpu_torch.core.v3 import V3
from mitsuba_im_tpu_torch.film.film import develop
from mitsuba_im_tpu_torch.render.job import render_film
from mitsuba_im_tpu_torch.scenes import large_scene, tiny_cornell

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


def _hierarchy(kind, dev):
    rng = np.random.default_rng(80)
    p0, e1, e2 = (rng.uniform(-s, s, (4000, 3)).astype(np.float32)
                  for s in (1.0, 0.3, 0.3))
    if kind == "plain":
        return hy.build_hierarchy(p0, e1, e2, dev)
    rot = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]],
                   np.float32)
    mats = [np.concatenate([np.eye(3, dtype=np.float32),
                            np.zeros((3, 1), np.float32)], 1),
            np.concatenate([rot * 1.3, np.array([[2.5], [0.2], [-0.4]],
                                                np.float32)], 1),
            np.concatenate([rot.T, np.array([[-2.0], [1.0], [1.5]],
                                            np.float32)], 1)]
    blas = [(p0, e1, e2, np.arange(len(p0), dtype=np.int64))]
    return hy.build_hierarchy_instanced(blas, [(0, m) for m in mats], dev)


@pytest.mark.parametrize("kind", ["plain", "instanced"])
def test_hierarchy_kernels_match_plain_version(cuda, kind):
    """hier_closest / hier_anyhit equal intersect_hierarchy_plain bit for
    bit: found, prim, inst, t, u, v and blocked, with and without a mask."""
    h = _hierarchy(kind, cuda)
    gen = torch.Generator(device=cuda).manual_seed(81)
    n = 100_003  # ragged last block
    o, d = _rays(gen, n, cuda)
    o = V3(*(c * 2.5 for c in o))
    tmax = torch.rand(n, generator=gen, device=cuda) * 4.0
    act = torch.rand(n, generator=gen, device=cuda) < 0.5
    ch.reset_launch_counts()
    for mask in (None, act):
        k = ch.hier_closest(h, o, d, 1e-4, 1e30, active=mask)
        p = hy.intersect_hierarchy_plain(h, o, d, 1e-4, 1e30, active=mask)[0]
        assert bool(p.found.any())
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        kb = ch.hier_anyhit(h, o, d, 1e-4, tmax, active=mask)
        pb = hy.intersect_hierarchy_plain(h, o, d, 1e-4, tmax, any_hit=True,
                                          active=mask)[0].found
        assert torch.equal(kb, pb)
    if kind == "instanced":
        assert len(set(p.inst[p.found].tolist())) == 3
    assert (ch.hier_closest.launches, ch.hier_anyhit.launches) == (2, 2)


def test_large_scene_render_card_vs_cpu(cuda):
    """A 20k-triangle large scene at 32^2, depth 3: every triangle query
    goes through the hierarchy kernels (3 closest + 2 any-hit launches per
    pass, no brute-force launch), and the image matches the CPU's."""
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene, settings = large_scene(dev, res=32, n_tris_target=20_000)
        ci.reset_launch_counts()
        ch.reset_launch_counts()
        imgs.append(develop(render_film(scene, settings, spp=2)).cpu().numpy())
        if dev.type == "cuda":
            assert (ch.hier_closest.launches, ch.hier_anyhit.launches) == (
                2 * 3, 2 * 2)
            assert (ci.closest_tris_v.launches,
                    ci.anyhit_tris_v.launches) == (0, 0)
    a, b = (im.sum(-1).ravel() for im in imgs)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2 * np.abs(b).mean())
    assert np.quantile(rel, 0.999) < 1e-3 and (rel > 1e-3).mean() < 2e-3
