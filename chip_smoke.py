#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mitsuba_im_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero:

1. device: require CUDA, print the card's name and power limit, turn TF32
   off;
2. build: compile ``csrc/tri_intersect.cu`` and ``csrc/hier_traverse.cu``
   with nvcc and ``csrc/bvh_build.cpp`` with the host C++ compiler, all
   three at once (each timed; ptxas register and spill report);
3. brute-force kernels vs their plain PyTorch versions on the card, bit
   for bit: 2^20 camera rays into the Cornell soup and 2^20 random rays
   into a random 512-triangle soup, with numbers and with tensors for
   tmin/tmax (a 0-dim tmin, an (N,) tmax with NaN lanes); the closest hit,
   the hit record (against its plain epilogue and against
   ``intersect.merge_hits``) and the any hit.  Both kernels timed at the
   Cornell path's shape (2^20 rays x 12 triangles) as the main path calls
   them (the hit record; any hit with an (N,) tmax): CUDA events around
   each call, in turns, median of 21, and the kernel's own device time
   (torch.profiler, median of 21); bounds from the bytes of that call, and
   (logged only) the modelled issue floor from the kernel's SASS
   (``tri_sass.py``, ``cuobjdump``);
4. the Cornell path: ``render_film`` at 1024^2, depth 5, 4 spp; 5
   closest-hit and 4 any-hit launches per pass; the image finite,
   non-negative, of plausible brightness, red on the left and green on the
   right; the pass time from differencing two pass counts;
5. card vs CPU on the Cornell box at 128^2 (and its skip_direct variant):
   parity_check.py's gate (sum rel < 5e-3, p999 per-pixel rel < 1e-3,
   bad-pixel fraction < 2e-3);
6. hierarchy kernels vs their plain version on the card, on the
   1,120,504-triangle large scene: the 768^2 camera rays of sample 0 and as
   many random rays from inside the scene's bounding sphere (closest hit),
   shadow rays from the camera hits toward the environment (any hit,
   finite tmax), both again with half the lanes masked off; a small
   instanced hierarchy (3 instances of a random soup); 300 instances of a
   64-triangle soup strung along one axis with rays along it (their first
   sweep enters more supers than the kernel's per-ray list holds); 3000
   instances of a 64-triangle soup (3000 supers, 94 runs of 32 for the
   first sweep's culling boxes): found, prim, inst, t, u, v and blocked must agree bit
   for bit.  Each case prints the kernel's sweep work (supers tested per
   ray, list overflows).  Both kernels are timed at 768^2 (CUDA events,
   kernel and plain version in turns, median of 11), and their bounds
   computed from the plain version's work counters (and again over the
   supers the kernel tests);
7. the large-scene path: ``render_film`` on ``scenes.large_scene("cuda")``
   at 768^2, depth 3, 2 spp; 3 ``hier_closest`` and 2 ``hier_anyhit``
   launches per pass and no brute-force launch; the image finite,
   non-negative, the mesh in the centre distinct from the unit
   environment in the corners; the pass time from differencing two pass
   counts (2,949,120 rays per pass); peak device memory;
8. card vs CPU on the same 1.12M-triangle scene at 64^2, depth 3:
   parity_check.py's gate.

The next-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mitsuba_im_tpu_torch.accel import bvh
from mitsuba_im_tpu_torch.accel import cuda_hierarchy as ch
from mitsuba_im_tpu_torch.accel import cuda_intersect as ci
from mitsuba_im_tpu_torch.accel import hierarchy as hy
from mitsuba_im_tpu_torch.accel import intersect as isect
from mitsuba_im_tpu_torch.core import rng
from mitsuba_im_tpu_torch.core.types import EPSILON, SHADOW_EPSILON, Int
from mitsuba_im_tpu_torch.core.v3 import V3
from mitsuba_im_tpu_torch.film.film import develop
from mitsuba_im_tpu_torch.integrators.path import PathConfig, path_li_v
from mitsuba_im_tpu_torch.render.job import render_film
from mitsuba_im_tpu_torch.scenes import large_scene, tiny_cornell
from mitsuba_im_tpu_torch.sensor.table import sample_ray_v
from tri_sass import ISSUE_PER_S, issue_floor_ms, kernel_costs, sass_text

RES = 1024
DEPTH = 5
SPP = 4
N_RAYS = 1 << 20
TRI_KERNELS = ("closest_kernel", "anyhit_kernel")
TRI_SOURCE = "mitsuba_im_tpu_torch/csrc/tri_intersect.cu"
HIER_SOURCE = "mitsuba_im_tpu_torch/csrc/hier_traverse.cu"
HIER_REPLACES = ("mitsuba_im_tpu/accel/hier_kernel.py:81, "
                 "mitsuba_im_tpu/accel/hier_kernel.py:285, "
                 "mitsuba_im_tpu/accel/hier_kernel.py:439")
L_RES = 768  # the large scene
L_DEPTH = 3
L_SPP = 2

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): memory rate
# and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
FLOP_TRI = 40  # one Moeller-Trumbore test
FLOP_BOX = 12  # one slab test


def log(msg):
    print(msg, flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()}")
    return smi


def build_phase():
    libs = {"tri_intersect.cu": ci.LIBRARY, "hier_traverse.cu": ch.LIBRARY,
            "bvh_build.cpp": bvh.LIBRARY}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.load) for lib in libs.values()]:
            f.result()
    log(f"[build] all libraries ready in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        log(f"[build] {name}: {lib.path().name}, compiler "
            f"{lib.seconds:.2f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps calls (CUDA events, warmed up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def median_ms_in_turns(fns, reps):
    """{name: median ms of one call}: each fn timed once per round with
    CUDA events, the functions in turns, ``reps`` rounds after a warm-up."""
    times = {k: [] for k in fns}
    for k, fn in fns.items():
        fn()
    torch.cuda.synchronize()
    for _ in range(reps):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(stop))
    return {k: statistics.median(v) for k, v in times.items()}


def device_ms_in_turns(fns, reps, names=TRI_KERNELS):
    """{name: median device ms of the kernel that each fn launches, named
    with one of ``names``}: torch.profiler's kernel durations, the
    functions in turns, ``reps`` rounds after a warm-up.  Each round is a
    profiler session of its own that calls the functions twice: the
    profiler can miss the first kernels of a session (it did when they
    ran for milliseconds), so the second pass is timed, its kernels the
    last ``len(fns)`` recorded, in the order of the calls.  A round is left
    out (logged) when fewer were recorded, or when the first pass's
    recorded kernels do not match the second's by name.  None for each
    function when no round was kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    n = len(fns)
    times = {k: [] for k in fns}
    left_out = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                for fn in fns.values():
                    fn()
                torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and any(s in e.name for s in names)),
                    key=lambda e: e.time_range.start)
        first, timed = ev[:-n], ev[-n:]
        m = min(len(first), n)
        if len(ev) < n or any(a.name != b.name for a, b in zip(
                first[len(first) - m:], timed[n - m:])):
            left_out.append(len(ev))
            continue
        for k, e in zip(fns, timed):
            times[k].append((e.time_range.end - e.time_range.start) / 1e3)
    if left_out:
        log(f"[profile] {len(left_out)} of {reps} rounds left out: the "
            f"profiler recorded {sorted(set(left_out))} kernels of "
            f"{2 * n} calls")
    return {k: statistics.median(v) if v else None
            for k, v in times.items()}


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def bound(nbytes, flops):
    """(bound_ms, bound_by) on the H100 from bytes moved and flops done."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOP_PER_S * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def tri_bounds(n, T):
    """Bounds of the brute-force queries of n rays against T triangles in
    the forms the main path calls them (tmin, tmax numbers for the closest
    hit, an (N,) tmax for the any hit): each ray reads o and d (24 B) and
    writes (t, u, v, prim, found) (17 B) or the hit record (24 B), or reads
    tmax and writes blocked (4 B + 1 B); the soup (36 B and a 4 B shape id
    per triangle) is read once; 40 flops per ray-triangle pair."""
    flops = n * T * FLOP_TRI
    return {"closest": bound(n * (24 + 17) + T * 36, flops),
            "record": bound(n * (24 + 24) + T * 40, flops),
            "anyhit": bound(n * (24 + 4 + 1) + T * 36, flops)}


def camera_rays(scene, n_side, sample=0):
    n = n_side * n_side
    pix = torch.arange(n, dtype=torch.int64, device=scene.device)
    s = rng.make_sampler_v(pix, sample, 0)
    s, blk = rng.next_block4_v(s)
    uu = ((pix % n_side).float() + blk[0]) / n_side
    vv = ((pix // n_side).float() + blk[1]) / n_side
    o, d, _ = sample_ray_v(scene.sensor, uu, vv, blk[2], blk[3])
    return s, o, d


def random_soup(gen, n_tris, n_rays, dev):
    """A random soup of n_tris triangles and n_rays rays from [-1, 1]^3
    (each ray component a contiguous (N,) tensor, as on the main path)."""
    def u(*shape):
        return torch.rand(*shape, generator=gen, device=dev) * 2.0 - 1.0

    def soa(a):
        return V3(*(a[:, k].contiguous() for k in range(3)))

    p0, e1, e2 = u(n_tris, 3), 0.3 * u(n_tris, 3), 0.3 * u(n_tris, 3)
    d = u(n_rays, 3)
    d = d / d.norm(dim=1, keepdim=True)
    return (p0, e1, e2), soa(u(n_rays, 3)), soa(d)


def mismatches(k, ref):
    """Elements in which the tensors of k and ref differ (a differing
    count, dtype or shape counts as everything)."""
    if len(k) != len(ref):
        return max(1, sum(a.numel() for a in k))
    n = 0
    for a, b in zip(k, ref):
        if a.dtype != b.dtype or a.shape != b.shape:
            n += max(a.numel(), b.numel(), 1)
        else:
            n += int((a != b).sum())
    return n


def max_abs_err(k, ref):
    """max |a - b| over the paired tensors of k and ref (bools as 0/1; a NaN
    in both counts as agreement, a NaN in one as an infinite error)."""
    err = 0.0
    for a, b in zip(k, ref):
        if not a.numel():
            continue
        a, b = a.double(), b.double()
        diff = torch.where((a == b) | (a.isnan() & b.isnan()), 0.0,
                           (a - b).abs().nan_to_num(nan=float("inf")))
        err = max(err, float(diff.max()))
    return err


def tri_forms(n, gen, dev):
    """(name, tmin, tmax) of the forms the brute-force kernels are checked
    in: numbers, and a 0-dim tmin with an (N,) tmax of NaN lanes."""
    tmax = torch.rand(n, generator=gen, device=dev) * 6.0
    tmax[::97] = float("nan")
    return [("numbers", 1e-4, 1e30),
            ("tensors", torch.tensor(1e-4, device=dev), tmax)]


def tri_cases(dev):
    """{name: dict(geom, o, d, forms, tmax)}: the Cornell box's geometry
    with the 2^20 camera rays of a 1024^2 image, and a random 512-triangle
    soup (in the Cornell geometry's place, no sphere or disk) with 2^20
    random rays; ``tmax`` is the (N,) any-hit tmax timed."""
    scene, _ = tiny_cornell(dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    _, o, d = camera_rays(scene, RES)
    (p0, e1, e2), o_r, d_r = random_soup(gen, ci.MAX_TRIS, N_RAYS, dev)
    soup = dataclasses.replace(
        scene.geom, tri_p0=p0, tri_e1=e1, tri_e2=e2, n_tris=ci.MAX_TRIS,
        tri_shape=torch.randint(0, 9, (ci.MAX_TRIS,), generator=gen,
                                device=dev, dtype=Int))
    out = {}
    for name, geom, oo, dd in (("cornell", scene.geom, o, d),
                               ("random512", soup, o_r, d_r)):
        out[name] = dict(
            geom=geom, o=oo, d=dd, forms=tri_forms(N_RAYS, gen, dev),
            tmax=torch.rand(N_RAYS, generator=gen, device=dev) * 6.0)
    return out


def check_tri(name, case):
    """Both brute-force kernels against their plain versions, bit for bit,
    in each tmin/tmax form: the closest hit, the hit record (against its
    plain epilogue and against intersect.merge_hits) and the any hit.
    Returns the largest |kernel - plain| of (closest: t, u, v of both
    queries; anyhit: blocked as 0/1)."""
    geom, o, d = case["geom"], case["o"], case["d"]
    tris = (geom.tri_p0, geom.tri_e1, geom.tri_e2)
    err = {"closest": 0.0, "anyhit": 0.0}
    for form, tmin, tmax in case["forms"]:
        p = ci.closest_tris_plain(*tris, o, d, tmin, tmax)
        k = ci.closest_tris_v(*tris, o, d, tmin, tmax)
        rec = ci.closest_hit_v(*tris, geom.tri_shape, o, d, tmin, tmax)
        prec = ci.hit_record_plain(geom.tri_shape, *p)
        merged = isect.merge_hits(geom, o, d, tmin, tmax, p)
        pb = ci.anyhit_tris_plain(*tris, o, d, tmin, tmax)
        kb = ci.anyhit_tris_v(*tris, o, d, tmin, tmax)
        mism = {
            "closest": mismatches(k, p),
            "record": mismatches(rec, prec),
            "record vs merge": mismatches(rec, [getattr(merged, f) for f in (
                "t", "kind", "prim", "shape", "u", "v")]),
            "anyhit": mismatches((kb,), (pb,))}
        err["closest"] = max(err["closest"], max_abs_err(k[:3], p[:3]),
                             max_abs_err([rec[i] for i in (0, 4, 5)],
                                         [prec[i] for i in (0, 4, 5)]))
        err["anyhit"] = max(err["anyhit"], max_abs_err((kb,), (pb,)))
        log(f"[kernels] {name}, tmin/tmax {form}: {o.x.shape[0]} rays x "
            f"{tris[0].shape[0]} triangles, found {int(p[4].sum())}, "
            f"blocked {int(pb.sum())}; mismatches "
            + ", ".join(f"{k} {v}" for k, v in mism.items())
            + f"; max |err| closest {err['closest']}, anyhit "
              f"{err['anyhit']}")
        if any(mism.values()):
            raise AssertionError(f"brute-force kernels disagree on {name}")
    return err


def kernel_phase(dev):
    cases = tri_cases(dev)
    err = {"closest": 0.0, "anyhit": 0.0}
    for name, case in cases.items():
        for k, e in check_tri(name, case).items():
            err[k] = max(err[k], e)

    # timings at the Cornell path's shape (2^20 rays x 12 triangles), as
    # the main path calls the kernels
    c = cases["cornell"]
    g, o, d, tmax = c["geom"], c["o"], c["d"], c["tmax"]
    tris = (g.tri_p0, g.tri_e1, g.tri_e2)
    calls = {
        "closest": lambda: ci.closest_hit_v(*tris, g.tri_shape, o, d, 1e-4,
                                            1e30),
        "anyhit": lambda: ci.anyhit_tris_v(*tris, o, d, 1e-4, tmax)}
    timing = median_ms_in_turns(calls, 21)
    device = device_ms_in_turns(calls, 21)
    timing.update(median_ms_in_turns({
        "closest_plain": lambda: isect.merge_hits(
            g, o, d, 1e-4, 1e30, ci.closest_tris_plain(*tris, o, d, 1e-4,
                                                       1e30)),
        "anyhit_plain": lambda: ci.anyhit_tris_plain(*tris, o, d, 1e-4,
                                                     tmax)}, 3))
    T = tris[0].shape[0]
    bounds = tri_bounds(N_RAYS, T)
    costs = kernel_costs(sass_text(ci.LIBRARY.path()))
    for k, q in (("closest", "record"), ("anyhit", "anyhit")):
        timing[f"{k}_device"] = device[k]
        timing[f"{k}_bound"] = bounds[q]
        timing[f"{k}_err"] = err[k]
        floor = issue_floor_ms(tris, o, d, 1e-4,
                               1e30 if k == "closest" else tmax, costs[q],
                               k == "anyhit")
        log(f"[kernels] {k} at 2^20 rays x {T} tris: events "
            f"{timing[k]:.4f} ms, device {fmt(device[k])} ms, plain "
            f"{timing[k + '_plain']:.4f} ms; bound {bounds[q][0]:.4f} ms "
            f"({bounds[q][1]}); SASS instructions per pair by stage reached "
            f"(det, u, v, all) {costs[q]}, issue floor {floor:.4f} ms "
            f"(a model: these costs at {ISSUE_PER_S:.4e} lane "
            f"instructions/s)")
    return timing


def luminance(img):
    return 0.212671 * img[..., 0] + 0.715160 * img[..., 1] \
        + 0.072169 * img[..., 2]


def pass_time(scene, settings, k_lo, k_hi, rays):
    """Per-pass ms from differencing two pass counts (cancels the fixed
    costs), as bench.py does."""
    def run(k):
        return lambda: render_film(scene, settings, spp=k)

    t_lo = min(cuda_ms(run(k_lo), 1) for _ in range(2))
    t_hi = min(cuda_ms(run(k_hi), 1) for _ in range(2))
    per_pass = (t_hi - t_lo) / (k_hi - k_lo)
    log(f"[main] pass time {per_pass:.3f} ms ({k_lo} passes {t_lo:.3f} ms, "
        f"{k_hi} passes {t_hi:.3f} ms); {rays} rays per pass; "
        f"{rays / (per_pass * 1e-3):.4e} rays/s")
    return per_pass


def main_path_phase(dev):
    scene, settings = tiny_cornell(dev)
    settings.width = settings.height = RES
    settings.spp = SPP
    settings.integrator_props = dict(max_depth=DEPTH)

    ci.reset_launch_counts()
    ch.reset_launch_counts()
    film = render_film(scene, settings)
    torch.cuda.synchronize()
    launches = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)
    log(f"[main] render_film {RES}x{RES} depth {DEPTH} spp {SPP}: "
        f"closest launches {launches[0]}, anyhit launches {launches[1]}")
    if launches != (DEPTH * SPP, (DEPTH - 1) * SPP):
        raise AssertionError(f"expected {DEPTH} closest and {DEPTH - 1} "
                             f"any-hit launches per pass, got {launches}")
    if ch.hier_closest.launches or ch.hier_anyhit.launches:
        raise AssertionError("the Cornell box launched hierarchy kernels")

    img = develop(film).cpu().numpy()
    lum = luminance(img)
    # the side walls fill columns ~2%-21% from each edge; sample their middle
    rows = slice(int(0.3 * RES), int(0.7 * RES))
    lo, hi = int(0.05 * RES), int(0.15 * RES)
    left = img[rows, lo:hi].mean((0, 1))
    right = img[rows, RES - hi:RES - lo].mean((0, 1))
    log(f"[main] image mean luminance {lum.mean():.5f}, "
        f"left rgb {np.round(left, 4).tolist()}, "
        f"right rgb {np.round(right, 4).tolist()}")
    if not np.isfinite(img).all() or (img < 0).any():
        raise AssertionError("image has non-finite or negative pixels")
    if not 0.05 < lum.mean() < 2.0:
        raise AssertionError(f"implausible mean luminance {lum.mean()}")
    if not (left[0] > left[1] and right[1] > right[0]):
        raise AssertionError("red wall not on the left / green not on right")
    pass_time(scene, settings, 2, 6, RES * RES * (1 + 2 * (DEPTH - 1)))
    return launches


def parity_gate(name, a, b):
    rel_sum = abs(float(a.sum()) - float(b.sum())) / max(abs(float(
        b.sum())), 1e-30)
    scale = max(float(np.abs(b).mean()), 1e-12)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2 * scale)
    p999 = float(np.quantile(rel, 0.999))
    frac_bad = float((rel > 1e-3).mean())
    ok = rel_sum < 5e-3 and p999 < 1e-3 and frac_bad < 2e-3
    log(f"[parity] {name}: cuda {a.sum():.6e} cpu {b.sum():.6e} rel "
        f"{rel_sum:.2e} p999 {p999:.2e} frac_bad {frac_bad:.2e} max_rel "
        f"{rel.max():.2e} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("card vs CPU parity gate failed")


def path_luminance(scene, n_side, depth, skip_direct=False):
    """parity_check._render_cornell on the port: per-pixel Li sum."""
    s, o, d = camera_rays(scene, n_side, sample=7)
    cfg = PathConfig(max_depth=depth, remat=False, skip_direct=skip_direct)
    li, _ = path_li_v(scene, s, o, d, cfg)
    return (li.x + li.y + li.z).cpu().numpy()


def parity_phase(dev):
    cuda_scene, _ = tiny_cornell(dev)
    cpu_scene, _ = tiny_cornell("cpu")
    for skip in (False, True):
        parity_gate(f"cornell 128^2 skip_direct={skip}",
                    path_luminance(cuda_scene, 128, DEPTH, skip),
                    path_luminance(cpu_scene, 128, DEPTH, skip))


# ---------------------------------------------------------------------------
# the large scene
# ---------------------------------------------------------------------------

def list_work(h, o, d, tmin, tmax, counts):
    """The kernel's sweep work, from the plain version's sweep counters and
    each ray's first sweep: (supers tested per ray, supers tested per ray
    were every sweep a full one, rays whose first sweep entered
    more supers than the list holds, mean list length).  A ray's first
    sweep tests the boxes of the runs of 32 supers (``sweep_groups``) and
    the supers of the runs it enters; a later one tests its list, or every
    super when the list overflowed."""
    comps, n, _ = ci._rays(o, d, tmin, tmax)
    inv = [hy._safe_inv(c) for c in comps[3:6]]
    S = h.n_supers
    gb = h.sweep_groups
    ng = gb.shape[1]
    sizes = torch.clamp_max(S - hy.SWEEP_GROUP * torch.arange(
        ng, device=gb.device), hy.SWEEP_GROUP)
    tb = torch.clamp_max(comps[7], hy.BIG)  # the best t of the first sweep
    entered = torch.empty(n, dtype=torch.int64, device=tb.device)
    first = torch.empty(n, dtype=torch.int64, device=tb.device)
    step = max(1, (1 << 24) // S)
    for a in range(0, n, step):
        r = slice(a, a + step)
        ray = ([c[r, None] for c in comps[:3]], [c[r, None] for c in inv],
               comps[6][r, None], tb[r, None])
        tn, tf = hy._slab([h.swp_lo[k, :S][None] for k in range(3)],
                          [h.swp_hi[k, :S][None] for k in range(3)], *ray)
        entered[r] = ((tn <= tf) & (tn < hy.FAR)).sum(1)
        tn, tf = hy._slab([gb[k][None] for k in range(3)],
                          [gb[3 + k][None] for k in range(3)], *ray)
        first[r] = ng + (((tn <= tf) & (tn < hy.FAR)) * sizes).sum(1)
    sw = counts.sweeps
    swept = sw > 0
    over = swept & (entered > ch.LIST_CAPACITY)
    tested = torch.where(
        swept, first + (sw - 1) * torch.where(over, S, entered), 0)
    mean_list = (float(entered[swept].float().mean()) if bool(swept.any())
                 else 0.0)
    return (float(tested.double().mean()), float((sw * S).double().mean()),
            int(over.sum()), mean_list)


def check_hier(name, h, o, d, tmin, tmax, active=None):
    """Both hierarchy kernels against the plain version, bit for bit.
    Returns (max |t| error, blocked flips, plain counters of closest)."""
    k = ch.hier_closest(h, o, d, tmin, tmax, active=active)
    p, counts = hy.intersect_hierarchy_plain(h, o, d, tmin, tmax,
                                             active=active)
    kb = ch.hier_anyhit(h, o, d, tmin, tmax, active=active)
    pb = hy.intersect_hierarchy_plain(h, o, d, tmin, tmax, any_hit=True,
                                      active=active)[0].found
    torch.cuda.synchronize()
    mism = {f: int((a != b).sum()) for f, a, b in zip(
        ("t", "u", "v", "prim", "inst", "found"), k, p)}
    t_err = float((k[0] - p[0]).abs().max()) if p[0].numel() else 0.0
    flips = int((kb != pb).sum())
    tested, full, over, mean_list = list_work(h, o, d, tmin, tmax, counts)
    log(f"[hier] {name}: {p.found.shape[0]} rays, {h.n_supers} supers, "
        f"found {int(p.found.sum())}, blocked {int(pb.sum())}; mismatches "
        + " ".join(f"{f} {m}" for f, m in mism.items())
        + f", max |t err| {t_err:.3e}, blocked flips {flips}; clusters per "
          f"ray {counts.clusters.float().mean().item():.4f}; closest: "
          f"supers tested per ray {tested:.2f} (every sweep full: "
          f"{full:.2f}), list {mean_list:.2f} entries, list overflows "
          f"{over}")
    if any(mism.values()) or flips:
        raise AssertionError(f"hierarchy kernels disagree on {name}")
    return t_err, flips, counts


def soup64(seed):
    g = np.random.default_rng(seed)
    tri = [g.uniform(-s, s, (64, 3)).astype(np.float32)
           for s in (0.5, 0.3, 0.3)]
    return (*tri, np.arange(64))


def translate(x, y, z):
    return np.concatenate([np.eye(3), [[x], [y], [z]]], 1).astype(np.float32)


def unit(v):
    return V3.from_array((v / v.norm(dim=1, keepdim=True)).contiguous())


def strung_soups(dev, n, gen):
    """300 instances of a 64-triangle soup strung along x (one super each,
    boxes overlapping); half the rays run along x through all of them, so
    their first sweep enters 300 supers, more than the list holds."""
    h = hy.build_hierarchy_instanced(
        [soup64(11)], [(0, translate(0.25 * k, 0, 0)) for k in range(300)],
        dev)
    o = torch.rand(n, 3, generator=gen, device=dev) * 0.8 - 0.4
    o[:, 0] = -3.0
    d = torch.randn(n, 3, generator=gen, device=dev)
    d[: n // 2, 0] = 1.0
    d[: n // 2, 1:] *= 0.005
    tmax = torch.rand(n, generator=gen, device=dev) * 90.0
    return h, V3.from_array(o.contiguous()), unit(d), tmax


def scattered_soups(dev, n, gen):
    """3000 instances of a 64-triangle soup on a 15 x 15 x 14 grid: 3000
    supers, whose 94 culling boxes take the first sweep three warp-wide
    steps."""
    h = hy.build_hierarchy_instanced(
        [soup64(12)], [(0, translate(1.2 * (k % 15), 1.2 * (k // 15 % 15),
                                     1.2 * (k // 225)))
                       for k in range(3000)], dev)
    o = torch.rand(n, 3, generator=gen, device=dev) * 18.0
    d = torch.randn(n, 3, generator=gen, device=dev)
    tmax = torch.rand(n, generator=gen, device=dev) * 20.0
    return h, V3.from_array(o.contiguous()), unit(d), tmax


def shadow_rays(scene, o, d, t, found, gen):
    """NEE toward the constant environment from the camera hits: origin at
    the hit, a uniform direction, tmax = far (1 - SHADOW_EPSILON) as
    path_li_v asks."""
    n = t.shape[0]
    p = o + d * torch.where(found, t, 0.0)
    u1, u2 = (torch.rand(n, generator=gen, device=t.device) for _ in "ab")
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * np.pi * u2
    w = V3(r * torch.cos(phi), r * torch.sin(phi), z)
    far = float(2.0 * scene.emitters.bsphere_radius + 1.0)
    tmax = torch.full((n,), far * (1.0 - SHADOW_EPSILON), device=t.device)
    return p, w, tmax


def hier_table_bytes(h):
    return sum(t.numel() * t.element_size() for t in (
        h.swp_lo, h.swp_hi, h.childs, h.blocks, h.sup_inst, h.root))


def hier_flops(h, counts, supers_tested=None):
    """Flops of a traversal with the plain version's counters; the sweeps
    test n_supers boxes each unless ``supers_tested`` (all rays) is given."""
    if supers_tested is None:
        supers_tested = int(counts.sweeps.sum()) * h.n_supers
    return (supers_tested * FLOP_BOX
            + int(counts.child_rows.sum()) * hy.SUP * FLOP_BOX
            + int(counts.clusters.sum()) * hy.LEAF * FLOP_TRI)


def work_spread(h, counts):
    """Per-ray flops of a traversal: (p50, p99, max, warp factor), the warp
    factor being the flops of 32 x each warp's heaviest ray over the total
    (1 when the rays of every warp do equal work)."""
    w = (counts.sweeps * h.n_supers * FLOP_BOX
         + counts.child_rows * hy.SUP * FLOP_BOX
         + counts.clusters * hy.LEAF * FLOP_TRI).double()
    q = torch.quantile(w, torch.tensor([0.5, 0.99], dtype=w.dtype,
                                       device=w.device))
    pad = (-w.numel()) % 32
    wmax = torch.cat([w, w.new_zeros(pad)]).view(-1, 32).amax(1)
    return (float(q[0]), float(q[1]), float(w.max()),
            float(32 * wmax.sum() / w.sum().clamp_min(1)))


def hier_phase(dev, scene):
    h = scene.clusters
    gen = torch.Generator(device=dev).manual_seed(4321)
    n = L_RES * L_RES
    log(f"[hier] large scene: {scene.geom.n_tris} triangles, "
        f"{h.n_supers} supers, {h.blocks.shape[0]} cluster rows, "
        f"tables {hier_table_bytes(h) / 2**20:.1f} MiB")

    _, o, d = camera_rays(scene, L_RES)
    c = scene.emitters.bsphere_center
    rad = float(scene.emitters.bsphere_radius)
    dirs = torch.randn(n, 3, generator=gen, device=dev)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    pts = torch.randn(n, 3, generator=gen, device=dev)
    pts = pts / pts.norm(dim=1, keepdim=True) * rad * torch.rand(
        n, 1, generator=gen, device=dev) ** (1 / 3) + c
    o_r, d_r = V3.from_array(pts.contiguous()), V3.from_array(
        dirs.contiguous())
    half = torch.rand(n, generator=gen, device=dev) < 0.5

    err_t, flips, cam_counts = check_hier("camera 768^2", h, o, d, EPSILON,
                                          1e30)
    check_hier("random in bounding sphere", h, o_r, d_r, EPSILON, 1e30)
    check_hier("camera 768^2, half masked", h, o, d, EPSILON, 1e30, half)
    t, _, _, _, _, found = ch.hier_closest(h, o, d, EPSILON, 1e30)
    p, w, tmax = shadow_rays(scene, o, d, t, found, gen)
    e2, f2, _ = check_hier("shadow rays", h, p, w, EPSILON, tmax, found)
    e3, f3, _ = check_hier("shadow rays, half masked", h, p, w, EPSILON,
                           tmax, found & half)
    err_t, flips = max(err_t, e2, e3), flips + f2 + f3

    soup_gen = np.random.default_rng(5)
    tri = [soup_gen.uniform(-s, s, (20000, 3)).astype(np.float32)
           for s in (1.0, 0.3, 0.3)]
    rot = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)
    mats = [np.concatenate([np.eye(3, dtype=np.float32),
                            np.zeros((3, 1), np.float32)], 1),
            np.concatenate([rot * 1.3, [[2.5], [0.2], [-0.4]]], 1),
            np.concatenate([rot.T, [[-2.0], [1.0], [1.5]]], 1)]
    hi_ = hy.build_hierarchy_instanced(
        [(*tri, np.arange(20000))], [(0, m) for m in mats], dev)
    o_i = V3.from_array((torch.rand(n, 3, generator=gen, device=dev) * 8
                         - 4).contiguous())
    e4, _, _ = check_hier("instanced (3 x 20000 tris)", hi_, o_i, d_r,
                          EPSILON, 1e30)
    err_t = max(err_t, e4)
    for name, make in (("list overflow (300 strung soups)", strung_soups),
                       ("many supers (3000 soups)", scattered_soups)):
        hs, o_s, d_s, tmax_s = make(dev, 1 << 16, gen)
        e5, f5, _ = check_hier(name, hs, o_s, d_s, EPSILON, tmax_s)
        err_t, flips = max(err_t, e5), flips + f5

    # timings at the main path's width: 768^2 camera rays (closest) and
    # their shadow rays (any hit)
    timing = median_ms_in_turns({
        "closest": lambda: ch.hier_closest(h, o, d, EPSILON, 1e30),
        "anyhit": lambda: ch.hier_anyhit(h, p, w, EPSILON, tmax, found),
    }, 11)
    timing.update(median_ms_in_turns({
        "closest_plain": lambda: hy.intersect_hierarchy_plain(
            h, o, d, EPSILON, 1e30),
        "anyhit_plain": lambda: hy.intersect_hierarchy_plain(
            h, p, w, EPSILON, tmax, any_hit=True, active=found),
    }, 3))
    sh_counts = hy.intersect_hierarchy_plain(h, p, w, EPSILON, tmax,
                                             any_hit=True, active=found)[1]
    tables = hier_table_bytes(h)
    nbytes = {"camera": n * (32 + 21) + tables,
              "shadow": n * (32 + 1 + 1) + tables}
    timing["closest_bound"] = bound(nbytes["camera"],
                                    hier_flops(h, cam_counts))
    timing["anyhit_bound"] = bound(nbytes["shadow"],
                                   hier_flops(h, sh_counts))
    for name, cnt, args in (
            ("camera", cam_counts, (o, d, EPSILON, 1e30)),
            ("shadow", sh_counts, (p, w, EPSILON, tmax))):
        p50, p99, wmax, warp = work_spread(h, cnt)
        tested, full, over, mean_list = list_work(h, *args, cnt)
        # the same bound over the supers this kernel tests
        own = bound(nbytes[name], hier_flops(h, cnt, round(tested * n)))
        log(f"[hier] work per {name} ray: sweeps "
            f"{cnt.sweeps.float().mean().item():.4f} (max "
            f"{int(cnt.sweeps.max())}), child picks "
            f"{cnt.child_rows.float().mean().item():.4f} (max "
            f"{int(cnt.child_rows.max())}), clusters "
            f"{cnt.clusters.float().mean().item():.4f} (max "
            f"{int(cnt.clusters.max())}); flops p50 {p50:.0f}, p99 "
            f"{p99:.0f}, max {wmax:.0f}, warp factor {warp:.3f}; kernel: "
            f"supers tested {tested:.2f} (every sweep full: {full:.2f}), "
            f"list {mean_list:.2f} entries, list overflows {over}; bound "
            f"over the supers it tests {own[0]:.4f} ms ({own[1]})")
    log("[hier] ms per call at 768^2 (median): "
        + ", ".join(f"{k} {v:.4f}" for k, v in timing.items()
                    if not k.endswith("bound"))
        + "; bounds "
        + ", ".join(f"{k} {v[0]:.4f} ({v[1]})" for k, v in timing.items()
                    if k.endswith("bound")))
    return err_t, float(flips > 0), timing


def large_path_phase(scene, settings):
    settings.spp = L_SPP
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    film = render_film(scene, settings)
    torch.cuda.synchronize()
    launches = (ch.hier_closest.launches, ch.hier_anyhit.launches)
    brute = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)
    log(f"[large] render_film {L_RES}x{L_RES} depth {L_DEPTH} spp {L_SPP}: "
        f"hier_closest launches {launches[0]}, hier_anyhit launches "
        f"{launches[1]}, brute-force launches {brute}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if launches != (L_DEPTH * L_SPP, (L_DEPTH - 1) * L_SPP) or any(brute):
        raise AssertionError(f"expected {L_DEPTH} hier_closest, "
                             f"{L_DEPTH - 1} hier_anyhit and no brute-force "
                             f"launches per pass, got {launches}, {brute}")
    img = develop(film).cpu().numpy()
    lum = luminance(img)
    q = L_RES // 8
    centre = lum[3 * q:5 * q, 3 * q:5 * q].mean()
    corners = np.mean([lum[:q, :q].mean(), lum[:q, -q:].mean(),
                       lum[-q:, :q].mean(), lum[-q:, -q:].mean()])
    log(f"[large] image mean luminance {lum.mean():.5f}, centre "
        f"{centre:.5f}, corners {corners:.5f}")
    if not np.isfinite(img).all() or (img < 0).any():
        raise AssertionError("image has non-finite or negative pixels")
    if abs(corners - 1.0) > 1e-3:
        raise AssertionError("the corners do not see the unit environment")
    if abs(centre - corners) < 0.05:
        raise AssertionError("the mesh does not show in the image centre")
    if not 0.2 < lum.mean() < 1.5:
        raise AssertionError(f"implausible mean luminance {lum.mean()}")
    pass_time(scene, settings, 1, 3,
              L_RES * L_RES * (1 + 2 * (L_DEPTH - 1)))
    return launches


def large_parity_phase(cuda_scene):
    cpu_scene, _ = large_scene("cpu")
    parity_gate(f"large scene ({cpu_scene.geom.n_tris} tris) 64^2 depth "
                f"{L_DEPTH}", path_luminance(cuda_scene, 64, L_DEPTH),
                path_luminance(cpu_scene, 64, L_DEPTH))


def kernel_record(name, source, replaces, launches, err, timing, key,
                  device_ms=None):
    bnd = timing[key + "_bound"]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=timing[key],
                plain_ms=timing[key + "_plain"], bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=None, device_ms=device_ms)


def main():
    smi = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    timing = kernel_phase(dev)
    launches = main_path_phase(dev)
    parity_phase(dev)

    t0 = time.perf_counter()
    scene, settings = large_scene(dev)
    log(f"[large] scene built on the host in {time.perf_counter() - t0:.2f} "
        f"s: {scene.geom.n_tris} triangles")
    err_h, err_ha, htiming = hier_phase(dev, scene)
    hlaunches = large_path_phase(scene, settings)
    large_parity_phase(scene)

    kernels = [
        kernel_record("tri_closest", TRI_SOURCE,
                      "mitsuba_im_tpu/accel/pallas_intersect.py:79",
                      launches[0], timing["closest_err"], timing, "closest",
                      timing["closest_device"]),
        kernel_record("tri_anyhit", TRI_SOURCE,
                      "mitsuba_im_tpu/accel/pallas_intersect.py:130",
                      launches[1], timing["anyhit_err"], timing, "anyhit",
                      timing["anyhit_device"]),
        kernel_record("hier_closest", HIER_SOURCE, HIER_REPLACES,
                      hlaunches[0], err_h, htiming, "closest"),
        kernel_record("hier_anyhit", HIER_SOURCE, HIER_REPLACES,
                      hlaunches[1], err_ha, htiming, "anyhit"),
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
