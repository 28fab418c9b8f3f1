"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
GPU).  Run on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Kernels against their plain PyTorch versions on the same card tensors
(brute force, and the hierarchy traversal on plain and instanced tables,
rays that overflow the kernel's per-ray super list, and 3000 supers),
the Cornell and large-scene renders on the card against the CPU
renders, and their gradients (path replay through the kernels) against
the CPU's; the environment map's alias sampling and the thirteen-family
``material_cornell`` render on the card against the CPU.
"""
import numpy as np
import pytest
import torch

from mitsuba_im_tpu_torch.accel import cuda_hierarchy as ch
from mitsuba_im_tpu_torch.accel import cuda_intersect as ci
from mitsuba_im_tpu_torch.accel import hierarchy as hy
from mitsuba_im_tpu_torch.core.v3 import V3
from mitsuba_im_tpu_torch.diff.optimize import get_params, render_rays, \
    set_params
from mitsuba_im_tpu_torch.film.film import develop
from mitsuba_im_tpu_torch.integrators.path import PathConfig
from mitsuba_im_tpu_torch.render.job import render_film
from mitsuba_im_tpu_torch.scenes import (SUN_DIR, large_scene,
                                         material_cornell, tiny_cornell)

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


def _same(k, p):
    return all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(k, p))


@pytest.mark.parametrize("T", [1, 12, 333, 512])
def test_kernels_match_plain_versions(cuda, T):
    """Both brute-force kernels equal their plain versions bit for bit:
    the closest hit, raw and as the hit record, and the any hit, with
    tmin/tmax as numbers and as tensors (0-dim, expanded, (N,) with NaN
    lanes), for no ray and for a ragged count; one launch per call with
    rays, none without."""
    gen = torch.Generator(device=cuda).manual_seed(T)
    tris = [torch.rand(T, 3, generator=gen, device=cuda) * s - s / 2
            for s in (2.0, 0.6, 0.6)]
    shape = torch.randint(0, 9, (T,), generator=gen, device=cuda,
                          dtype=torch.int32)
    for n in (0, 100_003):  # 100_003: a ragged last block
        o, d = _rays(gen, n, cuda)
        tmax = torch.rand(n, generator=gen, device=cuda) * 3.0
        tmax[::97] = float("nan")
        forms = [(1e-4, 1e30), (1e-4, tmax),
                 (torch.tensor(1e-4, device=cuda),
                  torch.tensor(2.0, device=cuda).expand(n)),
                 (torch.full((n,), 1e-4, device=cuda), tmax)]
        ci.reset_launch_counts()
        for tmin, tm in forms:
            p = ci.closest_tris_plain(*tris, o, d, tmin, tm)
            assert _same(ci.closest_tris_v(*tris, o, d, tmin, tm), p)
            assert _same(ci.closest_hit_v(*tris, shape, o, d, tmin, tm),
                         ci.hit_record_plain(shape, *p))
            assert torch.equal(ci.anyhit_tris_v(*tris, o, d, tmin, tm),
                               ci.anyhit_tris_plain(*tris, o, d, tmin, tm))
            if n:
                assert bool(p[4].any()) and not bool(p[4].all())
        calls = len(forms) if n else 0
        assert (ci.closest_tris_v.launches,
                ci.anyhit_tris_v.launches) == (2 * calls, calls)


def test_cornell_hit_record_matches_merge(cuda):
    """On the card, ``intersect_v`` of the Cornell box (the kernel's hit
    record) equals ``merge_hits`` of the plain closest hit bit for bit."""
    from mitsuba_im_tpu_torch.accel import intersect as isect

    gen = torch.Generator(device=cuda).manual_seed(7)
    g = tiny_cornell(cuda)[0].geom
    n = 100_003
    o, d = _rays(gen, n, cuda)
    o = V3(o.x * 0.6, o.y * 0.6 + 1.0, o.z * 0.6)  # inside the box
    ci.reset_launch_counts()
    hit = isect.intersect_v(g, o, d, 1e-4, 1e30)
    merged = isect.merge_hits(g, o, d, 1e-4, 1e30, ci.closest_tris_plain(
        g.tri_p0, g.tri_e1, g.tri_e2, o, d, 1e-4, 1e30))
    fields = ("t", "kind", "prim", "shape", "u", "v")
    assert _same([getattr(hit, f) for f in fields],
                 [getattr(merged, f) for f in fields])
    assert ci.closest_tris_v.launches == 1


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


def _soup64_instances(seed, offsets, dev):
    """Instances of one 64-triangle soup (one super each), translated."""
    rng = np.random.default_rng(seed)
    p0, e1, e2 = (rng.uniform(-s, s, (64, 3)).astype(np.float32)
                  for s in (0.5, 0.3, 0.3))
    mats = [np.concatenate([np.eye(3), np.array(x, np.float32)[:, None]],
                           1).astype(np.float32) for x in offsets]
    return hy.build_hierarchy_instanced(
        [(p0, e1, e2, np.arange(64))], [(0, m) for m in mats], dev)


def _case(kind, gen, n, dev):
    """(hierarchy, origins, directions, any-hit tmax) of a test case."""
    if kind == "list_overflow":  # rays along a string of 300 soups
        h = _soup64_instances(82, [(0.25 * k, 0, 0) for k in range(300)],
                              dev)
        o = torch.rand(n, 3, generator=gen, device=dev) * 0.8 - 0.4
        o[:, 0] = -3.0
        d = torch.randn(n, 3, generator=gen, device=dev)
        d[: n // 2, 0] = 1.0
        d[: n // 2, 1:] *= 0.005
        d = d / d.norm(dim=1, keepdim=True)
        tmax = torch.rand(n, generator=gen, device=dev) * 90.0
        return (h, V3.from_array(o.contiguous()),
                V3.from_array(d.contiguous()), tmax)
    if kind == "many_supers":  # 3000 soups on a grid
        h = _soup64_instances(83, [(1.2 * (k % 15), 1.2 * (k // 15 % 15),
                                    1.2 * (k // 225)) for k in range(3000)],
                              dev)
        o, d = _rays(gen, n, dev)
        o = V3(*(c * 6.0 + 8.4 for c in o))
        return h, o, d, torch.rand(n, generator=gen, device=dev) * 20.0
    h = _hierarchy(kind, dev)
    o, d = _rays(gen, n, dev)
    o = V3(*(c * 2.5 for c in o))
    return h, o, d, torch.rand(n, generator=gen, device=dev) * 4.0


def _most_supers_entered(h, o, d, tmin, tmax, n=4096):
    """The most supers the first sweep of one of the first n rays enters:
    above ch.LIST_CAPACITY the ray's list overflows."""
    S = h.n_supers
    inv = [hy._safe_inv(c[:n]) for c in d]
    tn, tf = hy._slab([h.swp_lo[k, :S][None] for k in range(3)],
                      [h.swp_hi[k, :S][None] for k in range(3)],
                      [c[:n, None] for c in o], [c[:, None] for c in inv],
                      torch.full((1, 1), tmin, device=h.device),
                      torch.clamp_max(tmax[:n, None], hy.BIG))
    return int(((tn <= tf) & (tn < hy.FAR)).sum(1).max())


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


@pytest.mark.parametrize("kind", ["plain", "instanced", "list_overflow",
                                  "many_supers"])
def test_hierarchy_kernels_match_plain_version(cuda, kind):
    """hier_closest / hier_anyhit equal intersect_hierarchy_plain bit for
    bit: found, prim, inst, t, u, v and blocked, with and without a mask.
    ``list_overflow``: rays whose first sweep enters more supers than the
    kernel's per-ray list holds (full sweeps after it); ``many_supers``:
    3000 supers."""
    gen = torch.Generator(device=cuda).manual_seed(81)
    n = 100_003  # ragged last block
    h, o, d, tmax = _case(kind, gen, n, cuda)
    if kind == "list_overflow":
        assert _most_supers_entered(h, o, d, 1e-4, tmax) > ch.LIST_CAPACITY
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


def test_hierarchy_ray_counters_left_zero(cuda):
    """Each launch leaves its stream's ray counters zero (the kernel's last
    block resets them), so launches of different sizes on one stream, and
    on a second stream with counters of its own, trace every ray."""
    gen = torch.Generator(device=cuda).manual_seed(82)
    h = _hierarchy("plain", cuda)
    streams = (torch.cuda.current_stream(cuda), torch.cuda.Stream(cuda))
    for stream in streams:
        with torch.cuda.stream(stream):
            for n in (100_003, 77, 4096):
                o, d = _rays(gen, n, cuda)
                o = V3(*(c * 2.5 for c in o))
                k = ch.hier_closest(h, o, d, 1e-4, 1e30)
                p = hy.intersect_hierarchy_plain(h, o, d, 1e-4, 1e30)[0]
                for a, b in zip(k, p):
                    assert torch.equal(a, b)
            counters = ch._COUNTERS[cuda, stream.cuda_stream]
            assert not bool(counters.any())
    torch.cuda.synchronize(cuda)


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


def _grads(scene, settings, cfg, labels):
    """d sum(Li)/d params of one sample per pixel."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in get_params(scene, labels).items()}
    pix = torch.arange(settings.width * settings.height, device=scene.device)
    render_rays(set_params(scene, params), settings, cfg, pix, 7,
                0).sum().backward()
    return {k: p.grad.cpu() for k, p in params.items()}


@pytest.mark.parametrize("which", ["cornell", "large"])
def test_gradient_replay_card_vs_cpu(cuda, which):
    """Path replay on the card: the backward pass runs the kernels again
    (Cornell, depth 5, remat_group 4: 5 + 4 launches forward, 9 + 8 in
    all; the large scene, depth 3, per bounce: 3 + 2 and 5 + 4), and the
    gradients at 32^2 match the CPU's (the plain versions) within
    parity_check.py's gradient gate, 5e-3."""
    if which == "cornell":
        labels = ("bsdf.refl", "emitter.radiance")
        cfg = PathConfig(max_depth=5, remat=True, remat_group=4)
        make = tiny_cornell
        counter = (ci.closest_tris_v, ci.anyhit_tris_v)
        want = (9, 8)
    else:
        labels = ("bsdf.alpha", "emitter.radiance")
        cfg = PathConfig(max_depth=3, remat=True)

        def make(dev):
            return large_scene(dev, res=32, n_tris_target=20_000)
        counter = (ch.hier_closest, ch.hier_anyhit)
        want = (5, 4)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        scene, settings = make(dev)
        settings.width = settings.height = 32
        ci.reset_launch_counts()
        ch.reset_launch_counts()
        grads.append(_grads(scene, settings, cfg, labels))
        if dev.type == "cuda":
            assert tuple(f.launches for f in counter) == want
    for k in labels:
        card, cpu = grads[0][k], grads[1][k]
        assert torch.isfinite(card).all() and cpu.abs().max() > 0
        assert (card - cpu).abs().max() / cpu.abs().max() < 5e-3, k


def test_alias_sampling_card_vs_cpu(cuda):
    """The Hosek sky's Distribution2D (resolution 512) samples the same
    cells on the card as on the CPU at 2^20 samples, and (u, v, pdf) to
    float32 tolerance."""
    from mitsuba_im_tpu_torch.core.distribution import Distribution2D
    from mitsuba_im_tpu_torch.emitter.hosek import hosek_sky_pixels

    pix = hosek_sky_pixels(512, SUN_DIR)
    lum = pix @ np.array([0.212671, 0.715160, 0.072169], np.float32)
    sin_t = np.sin((np.arange(256) + 0.5) / 256 * np.pi)[:, None]
    arrays = Distribution2D.arrays_from_weights(
        (lum * sin_t + 1e-12).astype(np.float32))
    gen = torch.Generator().manual_seed(5)
    u = torch.rand(2, 1 << 20, generator=gen)
    out = []
    for dev in (cuda, torch.device("cpu")):
        dist = Distribution2D.from_arrays(arrays, dev)
        out.append([t.cpu() for t in dist.sample_continuous(
            *u.to(dev).unbind(0))])
    (uc, vc, pc), (uh, vh, ph) = out
    assert torch.equal((uc * 512).floor(), (uh * 512).floor())
    assert torch.equal((vc * 256).floor(), (vh * 256).floor())
    for a, b in ((uc, uh), (vc, vh), (pc, ph)):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)


def test_material_cornell_render_card_vs_cpu(cuda):
    """The thirteen families under the area light and the sky at 32^2,
    depth 5, 2 spp: 5 closest + 4 any-hit launches per pass, no hierarchy
    launch, and the image within parity_check.py's gate of the CPU's."""
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene, settings = material_cornell(dev)
        settings.width = settings.height = 32
        ci.reset_launch_counts()
        ch.reset_launch_counts()
        imgs.append(develop(render_film(scene, settings, spp=2)).cpu().numpy())
        if dev.type == "cuda":
            assert (ci.closest_tris_v.launches,
                    ci.anyhit_tris_v.launches) == (2 * 5, 2 * 4)
            assert (ch.hier_closest.launches, ch.hier_anyhit.launches) == (
                0, 0)
    a, b = (im.sum(-1).ravel() for im in imgs)
    assert np.isfinite(a).all() and (a >= 0).all()
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2 * np.abs(b).mean())
    assert abs(a.sum() - b.sum()) / b.sum() < 5e-3
    assert np.quantile(rel, 0.999) < 1e-3 and (rel > 1e-3).mean() < 2e-3
