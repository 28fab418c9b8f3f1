"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
GPU).  Run on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Kernels against their plain PyTorch versions on the same card tensors
(brute force, and the hierarchy traversal on plain and instanced tables,
rays that overflow the kernel's per-ray super list, and 3000 supers),
the Cornell and large-scene renders on the card against the CPU
renders, and their gradients (path replay through the kernels) against
the CPU's; the environment map's alias sampling and the thirteen-family
``material_cornell`` render on the card against the CPU; the textured
Cornell render and its atlas gradient on the card against the CPU; every
sampler kind's blocks and the ``lights_cornell`` render (thin lens,
ldsampler, the Gaussian filter, every light) on the card against the CPU;
the hierarchy kernels' motion mode against the plain version at three
shutter times; the volumetric path tracer's shadow segments (closest hits
with a per-ray tmax) through both kernel families against the plain
versions, and ``volume_cornell`` and ``volume_large`` rendered on the card
against the CPU; the particle tracer and the bidirectional path tracer
through ``render`` on the Cornell box and the large scene against the CPU
with their launch counts, their means against the path tracer, and bdpt
against volpath on ``volume_cornell``; sppm, vpl, irrcache and adaptive
on the card against the CPU with their launch counts, and the photon and
VPL rays through both kernel families against the plain versions; the
subsurface scenes (dense and grid dipoles, single scatter) on the card
against the CPU with their launch counts, their shadow and refracted
rays through both kernel families, and pssmlt and erpt on the card
against the CPU; an mlt step of the caustic Cornell box on the card
against the CPU with its launches, and the manifold walk's re-projection
rays through both kernel families; ``render_sharded`` on a one-rank
``nccl`` group and an ``mtssrv`` node on the card against ``render_film``,
the interactive actor's film bit for bit ``render_film``'s, the gradient
through a subsurface scene and the motion integrator's sensor animation
on the card against the CPU.
"""
import dataclasses

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
from mitsuba_im_tpu_torch.core import rng
from mitsuba_im_tpu_torch.sampler import KIND_BY_NAME
from mitsuba_im_tpu_torch.accel import intersect as isect
from mitsuba_im_tpu_torch.media import medium as med
from mitsuba_im_tpu_torch.scenes import (SUN_DIR, large_scene,
                                         lights_cornell, material_cornell,
                                         subsurface_cornell, subsurface_grid,
                                         subsurface_large, textured_cornell,
                                         tiny_cornell, volume_cornell,
                                         volume_large)

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


@pytest.mark.parametrize("t", [0.0, 0.37, 1.0])
def test_hierarchy_motion_mode_matches_plain_version(cuda, t):
    """The motion mode (a deformable soup's two keyframes, rows lerped at
    the shutter time t) equals intersect_hierarchy_plain bit for bit, with
    and without a mask; at t = 0 it equals the static kernel on frame 0's
    rows."""
    rng = np.random.default_rng(83)
    p0, e1, e2 = (rng.uniform(-s, s, (4000, 3)).astype(np.float32)
                  for s in (1.0, 0.3, 0.3))
    q0 = (p0 + rng.uniform(-0.2, 0.2, p0.shape)).astype(np.float32)
    h = hy.build_hierarchy_motion(p0, e1, e2, q0, e1 * np.float32(1.1), e2,
                                  cuda).at_time(t)
    gen = torch.Generator(device=cuda).manual_seed(84)
    n = 100_003
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
    assert (ch.hier_closest.motion_launches,
            ch.hier_anyhit.motion_launches) == (2, 2)
    if t == 0.0:
        static = dataclasses.replace(h, has_motion=False)
        for a, b in zip(ch.hier_closest(h, o, d, 1e-4, 1e30),
                        ch.hier_closest(static, o, d, 1e-4, 1e30)):
            assert torch.equal(a, b)


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


def test_textured_cornell_render_card_vs_cpu(cuda):
    """Textures, MIP filtering with ray differentials, MASK, BLEND, bump
    and normal maps at 32^2, depth 5, 2 spp: 5 closest + 4 any-hit
    launches per pass, and the image within parity_check.py's gate of the
    CPU's."""
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene, settings = textured_cornell(dev)
        settings.width = settings.height = 32
        ci.reset_launch_counts()
        imgs.append(develop(render_film(scene, settings, spp=2)).cpu().numpy())
        if dev.type == "cuda":
            assert (ci.closest_tris_v.launches,
                    ci.anyhit_tris_v.launches) == (2 * 5, 2 * 4)
    a, b = (im.sum(-1).ravel() for im in imgs)
    assert np.isfinite(a).all() and (a >= 0).all()
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2 * np.abs(b).mean())
    assert abs(a.sum() - b.sum()) / b.sum() < 5e-3
    assert np.quantile(rel, 0.999) < 1e-3 and (rel > 1e-3).mean() < 2e-3


def test_atlas_gradient_card_vs_cpu(cuda):
    """d sum(Li)/d texture.atlas on textured_cornell at 32^2, depth 5,
    remat_group 4: 5 + 4 launches forward, 9 + 8 with the replay, and the
    gradient within parity_check.py's gradient gate (5e-3) of the CPU's."""
    cfg = PathConfig(max_depth=5, remat=True, remat_group=4)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        scene, settings = textured_cornell(dev)
        settings.width = settings.height = 32
        ci.reset_launch_counts()
        grads.append(_grads(scene, settings, cfg, ("texture.atlas",)))
        if dev.type == "cuda":
            assert (ci.closest_tris_v.launches,
                    ci.anyhit_tris_v.launches) == (9, 8)
    card, cpu = grads[0]["texture.atlas"], grads[1]["texture.atlas"]
    assert torch.isfinite(card).all() and cpu.abs().max() > 0
    assert (card - cpu).abs().max() / cpu.abs().max() < 5e-3


@pytest.mark.parametrize("name", list(KIND_BY_NAME))
def test_sampler_blocks_card_vs_cpu(cuda, name):
    """Six blocks of each sampler kind on the card equal the CPU's bit for
    bit, with a shared sample index and with one per lane."""
    idx = torch.randint(0, 64, (1 << 14,),
                        generator=torch.Generator().manual_seed(3))
    for sample in (7, idx):
        out = []
        for dev in (cuda, torch.device("cpu")):
            s = rng.make_sampler_v(torch.arange(1 << 14, device=dev),
                                   sample if isinstance(sample, int)
                                   else sample.to(dev), 5,
                                   kind=KIND_BY_NAME[name], spp=9)
            blocks = []
            for _ in range(6):
                s, u = rng.next_block4_v(s)
                blocks += [t.cpu() for t in u]
            out.append(blocks)
        assert _same(*out)


def test_lights_cornell_render_card_vs_cpu(cuda):
    """lights_cornell at 32^2, depth 5, 2 spp: 5 closest + 4 any-hit
    launches per pass, no hierarchy launch, the image within
    parity_check.py's gate of the CPU's."""
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene, settings = lights_cornell(dev)
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


def _volume_scene(which, dev):
    if which == "cornell":
        return volume_cornell(dev, grid_res=32, ori_res=8)
    return volume_large(dev, res=32, n_tris_target=100_000)


@pytest.mark.parametrize("which", ["cornell", "large"])
def test_volpath_segments_match_plain_versions(cuda, which):
    """The closest-hit kernels on volpath's shadow segments (tmin EPSILON,
    a per-ray tmax) equal their plain versions bit for bit."""
    from chip_smoke import segment_rays

    scene, settings = _volume_scene(which, cuda)
    segs = segment_rays(scene, settings, 64)
    for o, d, tmin, tmax in segs:
        assert isinstance(tmax, torch.Tensor) and tmax.shape == o.x.shape
        if which == "cornell":
            g = scene.geom
            tris = (g.tri_p0, g.tri_e1, g.tri_e2)
            assert _same(ci.closest_tris_v(*tris, o, d, tmin, tmax),
                         ci.closest_tris_plain(*tris, o, d, tmin, tmax))
            rec = ci.closest_hit_v(*tris, g.tri_shape, o, d, tmin, tmax)
            assert _same(rec, ci.hit_record_plain(
                g.tri_shape, *ci.closest_tris_plain(*tris, o, d, tmin,
                                                    tmax)))
        else:
            k = ch.hier_closest(scene.clusters, o, d, tmin, tmax)
            p, _ = hy.intersect_hierarchy_plain(scene.clusters, o, d, tmin,
                                                tmax)
            assert _same(k, p)


@pytest.mark.parametrize("which", ["cornell", "large"])
def test_volume_render_card_vs_cpu(cuda, which):
    """volume_cornell (16^2 at depth 5) and volume_large (32^2 at depth 3)
    at 2 spp: 5 (3) closest-hit launches a bounce, 25 (15) a pass, no
    any-hit launch, the same tracking iterations on both devices, and the
    image within parity_check.py's gate of the CPU's."""
    imgs, iters = [], []
    for dev in (cuda, torch.device("cpu")):
        scene, settings = _volume_scene(which, dev)
        settings.width = settings.height = 16 if which == "cornell" else 32
        ci.reset_launch_counts()
        ch.reset_launch_counts()
        med.reset_track_stats()
        imgs.append(develop(render_film(scene, settings, spp=2)).cpu().numpy())
        iters.append(med.TRACK_STATS["iterations"])
        if dev.type == "cuda":
            got = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches,
                   ch.hier_closest.launches, ch.hier_anyhit.launches)
            assert got == ((2 * 25, 0, 0, 0) if which == "cornell"
                           else (0, 0, 2 * 15, 0))
    assert iters[0] == iters[1]
    a, b = (im.sum(-1).ravel() for im in imgs)
    assert np.isfinite(a).all() and (a >= 0).all()
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2 * np.abs(b).mean())
    assert abs(a.sum() - b.sum()) / b.sum() < 5e-3
    assert np.quantile(rel, 0.999) < 1e-3 and (rel > 1e-3).mean() < 2e-3


def _gate_ok(a, b):
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2 * np.abs(b).mean())
    return (abs(a.sum() - b.sum()) / b.sum() < 5e-3
            and np.quantile(rel, 0.999) < 1e-3 and (rel > 1e-3).mean() < 2e-3)


# launches a pass (closest, any hit) of ptracer and bdpt at max_depth 5 on
# the Cornell box, and of bdpt at max_depth 3 on the large scene
LOOP_LAUNCHES = {("ptracer", "cornell"): (5, 5), ("bdpt", "cornell"): (9, 14),
                 ("bdpt", "large"): (5, 5)}


@pytest.mark.parametrize("integrator,which", list(LOOP_LAUNCHES))
def test_light_tracing_render_card_vs_cpu(cuda, integrator, which):
    """ptracer and bdpt through job.render at 64^2, 2 passes, on the card
    against the CPU under parity_check.py's gate; the launch counts a
    pass through the brute-force kernels (Cornell) or the hierarchy
    kernels (large scene), none through the other family."""
    from mitsuba_im_tpu_torch.render.job import render

    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene, settings = (tiny_cornell(dev) if which == "cornell"
                           else large_scene(dev))
        settings = dataclasses.replace(
            settings, width=64, height=64, integrator=integrator,
            integrator_props=dict(max_depth=5 if which == "cornell" else 3))
        ci.reset_launch_counts()
        ch.reset_launch_counts()
        imgs.append(render(scene, settings, spp=2).sum(-1).cpu().numpy())
        if dev.type == "cuda":
            c, a = LOOP_LAUNCHES[integrator, which]
            got = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches,
                   ch.hier_closest.launches, ch.hier_anyhit.launches)
            assert got == ((2 * c, 2 * a, 0, 0) if which == "cornell"
                           else (0, 0, 2 * c, 2 * a))
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0
    assert _gate_ok(*(im.ravel() for im in imgs))


@pytest.mark.parametrize("integrator", ["ptracer", "bdpt"])
def test_light_tracing_mean_matches_path_on_card(cuda, integrator):
    """The Cornell box at 64^2, depth 4: ptracer's and bdpt's means within
    5% of the path tracer's, each channel within 8%."""
    from mitsuba_im_tpu_torch.render.job import render

    scene, settings = tiny_cornell(cuda)
    settings = dataclasses.replace(settings, width=64, height=64,
                                   integrator_props=dict(max_depth=4))
    path = render(scene, settings, spp=64).cpu().numpy()
    img = render(scene, dataclasses.replace(settings, integrator=integrator),
                 spp=64).cpu().numpy()
    assert abs(img.mean() - path.mean()) / path.mean() < 0.05
    assert np.all(np.abs(img.mean((0, 1)) - path.mean((0, 1)))
                  / path.mean((0, 1)) < 0.08)


def test_bdpt_kajiya_kay_matches_volpath_on_card(cuda):
    """volume_cornell (its Kajiya-Kay, microflake and mixture phases
    through the port's phase functions in both integrators, ROADMAP C16)
    at 128^2, depth 5: bdpt's mean within 5% of volpath's; bdpt card vs
    CPU at 32^2 under the gate."""
    from mitsuba_im_tpu_torch.render.job import render

    scene, settings = volume_cornell(cuda, grid_res=32, ori_res=8)
    settings = dataclasses.replace(settings, width=128, height=128,
                                   integrator_props=dict(max_depth=5))
    vp = render(scene, settings, spp=16).cpu().numpy()
    bd = render(scene, dataclasses.replace(settings, integrator="bdpt"),
                spp=8).cpu().numpy()
    assert abs(bd.mean() - vp.mean()) / vp.mean() < 0.05
    small = dataclasses.replace(settings, width=32, height=32,
                                integrator="bdpt")
    cpu_scene, _ = volume_cornell("cpu", grid_res=32, ori_res=8)
    a, b = (render(s, small, spp=1).sum(-1).cpu().numpy().ravel()
            for s in (scene, cpu_scene))
    assert _gate_ok(a, b)


# the new loop integrators at 64^2 on the Cornell box: (integrator
# properties, passes, closest and any-hit launches of the render)
PHOTON_CASES = {
    "sppm": (dict(max_depth=5, photon_count=20000), 2, (2 * 12, 0)),
    "vpl": (dict(max_depth=4, vpl_count=64), 2, (2 * 7, 2 * 2)),
    "irrcache": (dict(resolution=4, irr_samples=48,
                      nested=dict(name="path", max_depth=3)), 1,
                 (1 + 4 + 1, 2 + 1)),
    "adaptive": (dict(max_error=0.05, max_spp=3,
                      nested=dict(name="path", max_depth=3)), 2,
                 (3 * 3 * 2, 3 * 2 * 2)),
}
# what the CPU run hands the card's: sppm's photons and irrcache's records
# (a photon's last bit decides its count at a radius and the radius
# update carries it on; a record on the box's edge starts its hemisphere
# rays on a wall's plane), so the gate holds every other stage
FED = {"sppm": ("sppm", "photon_trace"),
       "irrcache": ("irrcache", "cache_records")}


def _on(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _on(v, dev) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [_on(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


@pytest.mark.parametrize("integrator", list(PHOTON_CASES))
def test_photon_integrators_card_vs_cpu(cuda, integrator, monkeypatch):
    """sppm, vpl, irrcache and adaptive through job.render at 64^2: their
    launch counts on the card (sppm: the camera ray, six delta bounces and
    five photon bounces a pass; vpl: four delta bounces, two light
    bounces, the next-event ray and one wavefront of the 128 VPLs a pass;
    irrcache: the records' rays, one hemisphere wavefront, the final pass;
    adaptive: the nested path's launches for every sample of every
    round), and the card's image against the CPU's under
    parity_check.py's gate (sppm's passes given the CPU's photons,
    irrcache's final pass the CPU's records)."""
    import importlib

    from mitsuba_im_tpu_torch.render.job import render

    props, spp, launches = PHOTON_CASES[integrator]
    scenes = {}
    for dev in (cuda, torch.device("cpu")):
        scene, settings = tiny_cornell(dev)
        scenes[dev.type] = (scene, dataclasses.replace(
            settings, width=64, height=64, integrator=integrator,
            integrator_props=props))
    scene, settings = scenes["cuda"]
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    card = render(scene, settings, spp=spp).sum(-1).cpu().numpy()
    got = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches,
           ch.hier_closest.launches, ch.hier_anyhit.launches)
    assert got == (*launches, 0, 0)
    assert np.isfinite(card).all() and card.mean() > 0
    cpu_scene, cpu_settings = scenes["cpu"]
    if integrator not in FED:
        cpu = render(cpu_scene, cpu_settings, spp=spp).sum(-1).cpu().numpy()
        assert _gate_ok(card.ravel(), cpu.ravel())
        return
    mod_name, fn = FED[integrator]
    mod = importlib.import_module(
        f"mitsuba_im_tpu_torch.integrators.{mod_name}")
    orig, fed = getattr(mod, fn), []

    def record(*a, **kw):
        fed.append(orig(*a, **kw))
        return fed[-1]

    monkeypatch.setattr(mod, fn, record)
    cpu = render(cpu_scene, cpu_settings, spp=spp).sum(-1).cpu().numpy()
    given = iter(list(fed))
    monkeypatch.setattr(mod, fn, lambda *a, **kw: _on(next(given), cuda))
    card_fed = render(scene, settings, spp=spp).sum(-1).cpu().numpy()
    assert _gate_ok(card_fed.ravel(), cpu.ravel())
    # with its own photons or records, the card's image sum
    assert abs(card.sum() - cpu.sum()) / cpu.sum() < 5e-3


def test_photon_rays_match_plain_versions(cuda):
    """The photon tracer's rays (sppm on the Cornell box) and the VPL
    shadow rays through both brute-force kernels, and the photon rays of
    the large scene through both hierarchy kernels, bit for bit."""
    from mitsuba_im_tpu_torch.render.job import render

    for which in ("cornell", "large"):
        scene, settings = (tiny_cornell(cuda) if which == "cornell"
                           else large_scene(cuda))
        cases = [("sppm", dict(max_depth=3, photon_count=4096), 1,
                  "intersect_v", 8)]
        if which == "cornell":
            cases.append(("vpl", dict(max_depth=4, vpl_count=32), 1,
                          "occluded_v", 1))
        for integrator, props, spp, fn, call in cases:
            st = dataclasses.replace(settings, width=64, height=64,
                                     integrator=integrator,
                                     integrator_props=props)
            seen, orig = [], getattr(isect, fn)

            def spy(geom, o, d, tmin, tmax, **kw):
                seen.append((o, d, tmin, tmax))
                return orig(geom, o, d, tmin, tmax, **kw)

            setattr(isect, fn, spy)
            try:
                render(scene, st, spp=spp)
            finally:
                setattr(isect, fn, orig)
            o, d, tmin, tmax = seen[call]
            if which == "cornell":
                g = scene.geom
                tris = (g.tri_p0, g.tri_e1, g.tri_e2)
                assert _same(ci.closest_tris_v(*tris, o, d, tmin, tmax),
                             ci.closest_tris_plain(*tris, o, d, tmin, tmax))
                assert torch.equal(
                    ci.anyhit_tris_v(*tris, o, d, tmin, tmax),
                    ci.anyhit_tris_plain(*tris, o, d, tmin, tmax))
            else:
                h = scene.clusters
                k = ch.hier_closest(h, o, d, tmin, tmax)
                p, _ = hy.intersect_hierarchy_plain(h, o, d, tmin, tmax)
                assert all(torch.equal(a, b) for a, b in zip(k, p))
                assert torch.equal(
                    ch.hier_anyhit(h, o, d, tmin, tmax),
                    hy.intersect_hierarchy_plain(h, o, d, tmin, tmax,
                                                 any_hit=True)[0].found)


# subsurface scenes at 64^2: (maker, closest and any-hit launches of the
# table build, then of a 1-spp pass)
SUBSURFACE_CASES = {
    "cornell": (lambda dev: subsurface_cornell(dev, 64), (0, 8), (13, 8)),
    "grid": (lambda dev: subsurface_grid(dev, 64), (0, 8), (5, 4)),
}


@pytest.mark.parametrize("which", list(SUBSURFACE_CASES))
def test_subsurface_render_card_vs_cpu(cuda, which):
    """The dipole's table build (8 shadow wavefronts over the points) and a
    pass through ``render`` with the single-scatter estimator's 2 + 1
    launches a bounce on the card, its image against the CPU's under
    parity_check.py's gate; the grid case takes the hash grid's scan."""
    from mitsuba_im_tpu_torch import subsurface as ss
    from mitsuba_im_tpu_torch.render.job import render

    make, build, per_pass = SUBSURFACE_CASES[which]
    ci.reset_launch_counts()
    scene, settings = make(cuda)
    assert (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches) == build
    assert (scene.subsurface.n_points > ss.DENSE_MAX) == (which == "grid")
    ci.reset_launch_counts()
    card = render(scene, settings).sum(-1).cpu().numpy()
    assert (ci.closest_tris_v.launches,
            ci.anyhit_tris_v.launches) == per_pass
    cpu_scene, cpu_settings = make(torch.device("cpu"))
    cpu = render(cpu_scene, cpu_settings).sum(-1).cpu().numpy()
    assert _gate_ok(card.ravel(), cpu.ravel())


def test_subsurface_rays_match_plain_versions(cuda):
    """The irradiance points' shadow rays and the refracted rays of the
    single-scatter estimator through both kernel families, bit for bit:
    subsurface_cornell (brute force) and the large sphere (hierarchy)."""
    from mitsuba_im_tpu_torch.render.job import render

    for which in ("cornell", "large"):
        seen = {"occluded_v": [], "intersect_v": []}
        origs = {fn: getattr(isect, fn) for fn in seen}

        def spy_for(fn):
            def spy(geom, o, d, tmin, tmax, **kw):
                seen[fn].append((o, d, tmin, tmax))
                return origs[fn](geom, o, d, tmin, tmax, **kw)
            return spy

        for fn in seen:
            setattr(isect, fn, spy_for(fn))
        try:
            if which == "cornell":
                scene, settings = subsurface_cornell(cuda, 64)
            else:
                scene, settings = subsurface_large(cuda, "dipole", 64)
                single = subsurface_large(cuda, "singlescatter", 64)
                scene_s, settings_s = single
            shadow = seen["occluded_v"][0]
            seen["intersect_v"].clear()
            render(*(single if which == "large" else (scene, settings)))
        finally:
            for fn, orig in origs.items():
                setattr(isect, fn, orig)
        refracted = seen["intersect_v"][1]
        for o, d, tmin, tmax in (shadow, refracted):
            if which == "cornell":
                g = scene.geom
                tris = (g.tri_p0, g.tri_e1, g.tri_e2)
                assert _same(ci.closest_tris_v(*tris, o, d, tmin, tmax),
                             ci.closest_tris_plain(*tris, o, d, tmin, tmax))
                assert torch.equal(
                    ci.anyhit_tris_v(*tris, o, d, tmin, tmax),
                    ci.anyhit_tris_plain(*tris, o, d, tmin, tmax))
            else:
                h = scene.clusters
                k = ch.hier_closest(h, o, d, tmin, tmax)
                p, _ = hy.intersect_hierarchy_plain(h, o, d, tmin, tmax)
                assert all(torch.equal(a, b) for a, b in zip(k, p))
                assert torch.equal(
                    ch.hier_anyhit(h, o, d, tmin, tmax),
                    hy.intersect_hierarchy_plain(h, o, d, tmin, tmax,
                                                 any_hit=True)[0].found)


@pytest.mark.parametrize("integrator", ["pssmlt", "erpt"])
def test_mcmc_card_vs_cpu(cuda, integrator):
    """pssmlt (bidirectional, 512 chains) and erpt (unidirectional, chain
    length 4) through ``render`` at 32^2, depth 4: their launches (7 + 9
    an evaluation bidirectionally, 4 + 3 a replay),
    ``_eval`` of the same tables card vs CPU within rel 1e-4 on all but
    1% of the lanes, and the image's luminance sum against the CPU's
    within 2% (a chain whose acceptance flips on a last bit walks another
    way, so the images are not gated per pixel)."""
    from mitsuba_im_tpu_torch.integrators import pssmlt
    from mitsuba_im_tpu_torch.render.job import render

    props = (dict(max_depth=4, n_chains=512, burn_in=4)
             if integrator == "pssmlt" else dict(max_depth=4, chain_length=4))
    imgs = {}
    for dev in (cuda, torch.device("cpu")):
        scene, settings = tiny_cornell(dev)
        settings = dataclasses.replace(settings, width=32, height=32,
                                       integrator=integrator,
                                       integrator_props=props)
        ci.reset_launch_counts()
        imgs[dev.type] = render(scene, settings, spp=4).cpu().numpy()
        if dev.type == "cuda":
            if integrator == "pssmlt":
                evals, per = 8 + 32 * 32 * 4 // 512, (7, 9)
            else:
                evals, per = 4 * 5, (4, 3)
            assert (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches) \
                == (per[0] * evals, per[1] * evals)
            card_scene = scene
        cfg = pssmlt.pssmlt_config(scene, settings) if integrator == \
            "pssmlt" else pssmlt.PSSMLTConfig(max_depth=4, n_chains=512)
    table = pssmlt._draw_table(torch.arange(512), 3, 7,
                               pssmlt._n_blocks(cfg), 1)
    cfg = dataclasses.replace(cfg, n_chains=512)
    a = pssmlt._eval(card_scene, table.to(cuda), cfg, 32, 32)
    b = pssmlt._eval(scene, table, cfg, 32, 32)
    rel = ((a[1].cpu() - b[1]).abs() / b[1].abs().clamp_min(1e-3)
           ).flatten(1).amax(1)
    assert int((rel > 1e-4).sum()) <= 5
    lum = [(x * np.array([0.212671, 0.715160, 0.072169])).sum()
           for x in (imgs["cuda"], imgs["cpu"])]
    assert np.isfinite(imgs["cuda"]).all() and lum[0] > 0
    assert abs(lum[0] - lum[1]) / lum[1] < 0.02


def test_mlt_card_vs_cpu(cuda):
    """One mlt step of ``caustic_cornell`` at 64^2 (1,024 chains, depth 5,
    p_manifold 0.15) on the card and the CPU from the same tables:
    ``chip_smoke.py`` phase 57's gates (the other mutations' proposals to
    2 ulp on the circle, the manifold moves alike on >= 99% and their
    factors within rel 1e-3, the targets within rel 1e-4 on >= 99.5%, the
    acceptance decisions alike on >= 99.5%), and the card's launches: 9 +
    14 an evaluation and the manifold walks' closest hits by the patterns
    their lanes matched (``chip_smoke.walk_launches``)."""
    from chip_smoke import manifold_lanes, walk_launches
    from mitsuba_im_tpu_torch.integrators import mlt, pssmlt
    from mitsuba_im_tpu_torch.render.job import RenderSettings
    from mitsuba_im_tpu_torch.scenes import caustic_cornell

    n, res, seed, t = 1024, 64, 3, 1
    settings = RenderSettings(width=res, height=res, spp=1,
                              integrator="mlt", integrator_props=dict(
                                  max_depth=5, n_chains=n, p_manifold=0.15))
    scenes = [caustic_cornell(d, res)[0] for d in (cuda, "cpu")]
    cfg = mlt.mlt_config(scenes[0], settings)
    pss = mlt._pss_cfg(cfg)
    chain = torch.arange(n)
    table = pssmlt._draw_table(chain, 0xFFFFFFFF, seed,
                               pssmlt._n_blocks(pss), 0)
    idx, u_aux = manifold_lanes(cfg, seed, t)
    others = torch.ones(n, dtype=torch.bool)
    others[idx] = False
    out = []
    for sc in scenes:
        d = sc.device
        ci.reset_launch_counts()
        prop, large, _ = mlt.mlt_step_tables(table.to(d), u_aux.to(d), cfg,
                                             chain.to(d), t, seed, scene=sc)
        walks = ci.closest_tris_v.launches
        info = {}
        m = mlt._manifold_tables(sc, table.to(d)[idx.to(d)], cfg,
                                 u_aux.to(d)[idx.to(d), 1:3],
                                 chain=idx.to(d), info=info)
        I_p = pssmlt._eval(sc, prop, pss, res, res)[2]
        out.append([x.cpu() for x in (prop, large, m[1], m[2], I_p)])
        if d.type == "cuda":
            walk = walk_launches(cfg.max_depth, info)
            assert walks == walk
            pos, color, I = pssmlt._eval(sc, table.to(d), pss, res, res)
            state = (table, pos.cpu(), color.cpu(), I.cpu(), I.sum().cpu(),
                     torch.tensor(float(n)))
    (pa, la, ca, ma, Ia), (pb, lb, cb, mb, Ib) = out
    diff = (pa - pb).abs()[others]
    assert torch.minimum(diff, 1.0 - diff).max() <= 2 * 2.0 ** -24
    assert torch.equal(la, lb)
    assert (ma == mb).float().mean() >= 0.99
    both = ma & mb
    assert ((ca - cb).abs() / cb.abs())[both].max() <= 1e-3 if both.any() \
        else True
    assert ((Ia - Ib).abs() <= 1e-4 * Ib.abs()).float().mean() >= 0.995
    acc = []
    for sc in scenes:
        d = sc.device
        ci.reset_launch_counts()
        _, new = mlt.mlt_run(sc, torch.zeros((res, res, 3), device=d),
                             tuple(x.to(d) for x in state), seed, t, cfg=cfg,
                             width=res, height=res, n_steps=1,
                             accumulate=True)
        if d.type == "cuda":
            assert (ci.closest_tris_v.launches,
                    ci.anyhit_tris_v.launches) == (9 + walk, 14)
        acc.append((new[0].cpu() != table).any(2).any(1))
    assert (acc[0] == acc[1]).float().mean() >= 0.995


@pytest.mark.parametrize("which", ["cornell", "large"])
def test_manifold_reprojection_rays_both_families(cuda, which):
    """The Newton walk's re-projection rays of a manifold step (each
    chain length's, on caustic_cornell; on the large scene, where no lane
    matches, the walk the reference runs on the manifold lanes) through
    both kernel families against their plain versions, bit for bit."""
    from chip_smoke import manifold_lanes, reference_walk, walk_launches
    from mitsuba_im_tpu_torch.integrators import mlt, pssmlt
    from mitsuba_im_tpu_torch.scenes import caustic_cornell

    if which == "cornell":
        scene, _ = caustic_cornell(cuda, 64)
        depth = 5
    else:
        scene, _ = large_scene(cuda, 64)
        depth = 3
    cfg = mlt.MLTConfig(max_depth=depth, n_chains=2048, p_manifold=0.15)
    table = pssmlt._draw_table(torch.arange(2048), 0xFFFFFFFF, 5,
                               pssmlt._n_blocks(mlt._pss_cfg(cfg)), 0)
    idx, u_aux = manifold_lanes(cfg, 5, 1)
    seen, orig, info = [], isect.intersect_v, {}

    def spy(geom, o, d, tmin, tmax, **kw):
        seen.append((o, d, tmin, tmax))
        return orig(geom, o, d, tmin, tmax, **kw)

    isect.intersect_v = spy
    try:
        if which == "cornell":
            mlt._manifold_tables(scene, table.to(cuda)[idx.to(cuda)], cfg,
                                 u_aux.to(cuda)[idx.to(cuda), 1:3],
                                 chain=idx.to(cuda), info=info)
        else:
            reference_walk(scene, table, cfg, 5, 1)()
    finally:
        isect.intersect_v = orig
    assert len(seen) == (walk_launches(depth, info) if which == "cornell"
                         else depth + 21)
    assert len(seen) > depth
    for o, d, tmin, tmax in seen[depth::7]:
        if which == "cornell":
            g = scene.geom
            tris = (g.tri_p0, g.tri_e1, g.tri_e2)
            assert _same(ci.closest_tris_v(*tris, o, d, tmin, tmax),
                         ci.closest_tris_plain(*tris, o, d, tmin, tmax))
        else:
            h = scene.clusters
            k = ch.hier_closest(h, o, d, tmin, tmax)
            p, _ = hy.intersect_hierarchy_plain(h, o, d, tmin, tmax)
            assert all(torch.equal(a, b) for a, b in zip(k, p))


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cornell(dev, res, spp):
    scene, settings = tiny_cornell(dev)
    settings.width = settings.height = res
    settings.spp = spp
    settings.integrator_props = dict(max_depth=5)
    return scene, settings


def test_sharded_render_on_one_nccl_rank(cuda):
    """``render_sharded`` on a one-rank ``nccl`` group: 5 + 4 launches a
    pass, the image within parity_check.py's gate of ``render_film``'s."""
    import torch.distributed as tdist

    from mitsuba_im_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                  device=cuda)
    try:
        assert tdist.get_backend() == "nccl" and mesh.group is not None
        scene, settings = _cornell(cuda, 64, 2)
        ci.reset_launch_counts()
        img = pmesh.render_sharded(mesh, scene, settings)
        assert (ci.closest_tris_v.launches,
                ci.anyhit_tris_v.launches) == (10, 8)
        ref = develop(render_film(scene, settings))
        assert _gate_ok(img.sum(-1).cpu().numpy().ravel(),
                        ref.sum(-1).cpu().numpy().ravel())
    finally:
        tdist.destroy_process_group()


def test_render_node_on_the_card(cuda):
    """An ``mtssrv -ls`` node on the card and this process share a 64^2
    render: each renders a unit, no error, the image within the gate of
    ``render_film``'s."""
    import sys

    from mitsuba_im_tpu_torch.parallel import remote

    scene, settings = _cornell(cuda, 64, 4)
    node = remote.RemoteNode([sys.executable, "-m",
                              "mitsuba_im_tpu_torch.cli.mtssrv", "-ls",
                              "-q"])
    assert node.platform == "cuda"
    job = remote.render_distributed(scene, settings, [node], unit_spp=1)
    assert not job.errors
    assert all(w.units >= 1 for w in job.workers.values()), job.workers
    ref = develop(render_film(scene, settings))
    assert job.image.device == ref.device
    assert _gate_ok(job.image.sum(-1).cpu().numpy().ravel(),
                    ref.sum(-1).cpu().numpy().ravel())


def test_actor_film_is_render_film_on_card(cuda):
    """The interactive actor's film after 3 passes on the card is
    ``render_film``'s 3-spp film bit for bit (the box splat's
    ``index_put_``), 5 + 4 launches a pass with the preview's."""
    from mitsuba_im_tpu_torch.interactive.actor import RenderActor

    scene, settings = _cornell(cuda, 64, 3)
    ci.reset_launch_counts()
    actor = RenderActor(scene, settings, preview_scale=4, max_spp=3).start()
    actor._thread.join(timeout=120)
    assert actor.error is None and actor.spp_done == 3
    assert (ci.closest_tris_v.launches,
            ci.anyhit_tris_v.launches) == (20, 16)
    ref = develop(render_film(scene, settings, spp=3)).cpu().numpy()
    np.testing.assert_array_equal(actor.latest().image, ref)


def test_subsurface_gradient_card_vs_cpu(cuda):
    """d sum(Li)/d refl through ``subsurface_cornell`` (ROADMAP C1) at
    32^2, depth 3: the card's within the gradient gate (5e-3) of the
    CPU's."""
    g = []
    for dev in (cuda, torch.device("cpu")):
        scene, settings = subsurface_cornell(dev, 32)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in get_params(scene, ["bsdf.refl"]).items()}
        li = render_rays(set_params(scene, params), settings,
                         PathConfig(max_depth=3), torch.arange(
                             32 * 32, device=dev), 0, 0)
        li.sum().backward()
        g.append(params["bsdf.refl"].grad.cpu())
    assert torch.isfinite(g[0]).all() and g[1].abs().max() > 0
    assert ((g[0] - g[1]).abs().max() / g[1].abs().max()).item() < 5e-3


def test_motion_sensor_animation_card_vs_cpu(cuda):
    """The motion integrator's previous pose from an ``AnimatedTransform``
    on the card against the CPU at 32^2."""
    from mitsuba_im_tpu_torch.core.track import AnimatedTransform
    from mitsuba_im_tpu_torch.core.transform import Transform

    imgs = []
    for dev in (cuda, torch.device("cpu")):
        scene, settings = _cornell(dev, 32, 1)
        m = scene.sensor.to_world.cpu().double().numpy()
        settings.integrator = "motion"
        settings.integrator_props = {"sensor_animation": AnimatedTransform(
            [-0.5, 0.0], [Transform(m @ Transform.translate(
                [0.1, -0.05, 0.2]).m), Transform(m)]), "time_delta": 0.25}
        imgs.append(develop(render_film(scene, settings)).cpu().numpy())
    assert np.abs(imgs[1][..., :2]).max() > 0.1
    assert _gate_ok(np.abs(imgs[0]).sum(-1).ravel(),
                    np.abs(imgs[1]).sum(-1).ravel())
