#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mitsuba_im_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero:

1. device: require CUDA, print the card's name and power limit, turn TF32
   off;
2. build: compile ``csrc/tri_intersect.cu`` with nvcc (timed);
3. kernels vs their plain PyTorch versions on the card: 2^20 camera rays
   into the Cornell soup and 2^20 random rays into a random 512-triangle
   soup; found/prim exact except exact-t ties (< 1e-4 of rays), t/u/v to
   rel 1e-5, blocked exact except < 1e-4 edge flips; both timed at the main
   path's shape (2^20 rays x 12 triangles);
4. the main path: ``render_film`` on the Cornell box at 1024^2, depth 5,
   4 spp; the launch counters must show 5 closest-hit and 4 any-hit
   launches per pass; the image must be finite, non-negative, of plausible
   brightness, red on the left and green on the right; the pass time comes
   from differencing two pass counts (as bench.py does) with CUDA events;
5. card vs CPU: the 128^2 Cornell render (and its skip_direct variant) on
   CUDA (kernels) and on the CPU (plain versions) must pass parity_check.py's
   gate: sum rel < 5e-3, p999 per-pixel rel < 1e-3, bad-pixel fraction
   < 2e-3.

The next-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from mitsuba_im_tpu_torch.accel import cuda_intersect as ci
from mitsuba_im_tpu_torch.core import rng
from mitsuba_im_tpu_torch.core.v3 import V3
from mitsuba_im_tpu_torch.film.film import develop
from mitsuba_im_tpu_torch.integrators.path import PathConfig, path_li_v
from mitsuba_im_tpu_torch.render.job import render_film
from mitsuba_im_tpu_torch.scenes import tiny_cornell
from mitsuba_im_tpu_torch.sensor.table import sample_ray_v

RES = 1024
DEPTH = 5
SPP = 4
N_RAYS = 1 << 20
TIE_FRAC = 1e-4  # rays allowed to differ in found/prim (exact-t ties, edges)
RTOL = 1e-5  # t/u/v agreement (rel; abs for |x| < 1)
SOURCE = "mitsuba_im_tpu_torch/csrc/tri_intersect.cu"


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
    t0 = time.perf_counter()
    ci.load_library()
    log(f"[build] {ci.library_path().name} ready in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {ci.build_seconds:.2f} s)")
    for line in ci.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"[build] {line.strip()}")


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
    def u(*shape):
        return torch.rand(*shape, generator=gen, device=dev) * 2.0 - 1.0

    p0, e1, e2 = u(n_tris, 3), 0.3 * u(n_tris, 3), 0.3 * u(n_tris, 3)
    d = u(n_rays, 3)
    d = d / d.norm(dim=1, keepdim=True)
    return (p0, e1, e2), V3.from_array(u(n_rays, 3).contiguous()), \
        V3.from_array(d.contiguous())


def compare_closest(name, k, p):
    """k, p: (t, u, v, prim, found) from the kernel and the plain version."""
    n = k[0].shape[0]
    found_diff = int((k[4] != p[4]).sum())
    both = k[4] & p[4]
    prim_diff = both & (k[3] != p[3])
    t_k, t_p = k[0][both], p[0][both]
    # a prim mismatch must be a tie: the same t to RTOL
    tie_ok = bool(torch.all((k[0][prim_diff] - p[0][prim_diff]).abs()
                            <= RTOL * p[0][prim_diff].abs()))
    same = both & ~prim_diff
    errs = []
    for a, b in zip(k[:3], p[:3]):
        a, b = a[same], b[same]
        errs.append(float(((a - b).abs()
                           / torch.clamp_min(b.abs(), 1.0)).max())
                    if a.numel() else 0.0)
    max_abs = float((t_k - t_p).abs().max()) if t_k.numel() else 0.0
    n_prim = int(prim_diff.sum())
    log(f"[kernels] closest {name}: {n} rays, found {int(p[4].sum())}, "
        f"found mismatches {found_diff}, prim mismatches {n_prim} "
        f"(ties ok: {tie_ok}), max rel err t/u/v "
        f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}")
    if found_diff + n_prim >= TIE_FRAC * n or not tie_ok \
            or max(errs) > RTOL:
        raise AssertionError(f"closest-hit kernel disagrees on {name}")
    return max_abs


def compare_anyhit(name, k, p):
    n = k.shape[0]
    flips = int((k != p).sum())
    log(f"[kernels] anyhit {name}: {n} rays, blocked {int(p.sum())}, "
        f"flips {flips}")
    if flips >= TIE_FRAC * n:
        raise AssertionError(f"any-hit kernel disagrees on {name}")
    return float(flips > 0)


def kernel_phase(dev):
    scene, _ = tiny_cornell(dev)
    g = scene.geom
    tris = (g.tri_p0, g.tri_e1, g.tri_e2)
    _, o, d = camera_rays(scene, RES)
    gen = torch.Generator(device=dev).manual_seed(1234)
    tmax_any = torch.rand(N_RAYS, generator=gen, device=dev) * 6.0
    cases = [("cornell", tris, o, d)]
    soup, o_r, d_r = random_soup(gen, ci.MAX_TRIS, N_RAYS, dev)
    cases.append(("random512", soup, o_r, d_r))

    err_c = err_a = 0.0
    for name, tr, oo, dd in cases:
        k = ci.closest_tris_v(*tr, oo, dd, 1e-4, 1e30)
        p = ci.closest_tris_plain(*tr, oo, dd, 1e-4, 1e30)
        torch.cuda.synchronize()
        err_c = max(err_c, compare_closest(name, k, p))
        k = ci.anyhit_tris_v(*tr, oo, dd, 1e-4, tmax_any)
        p = ci.anyhit_tris_plain(*tr, oo, dd, 1e-4, tmax_any)
        torch.cuda.synchronize()
        err_a = max(err_a, compare_anyhit(name, k, p))

    # timings at the main path's shape: 2^20 rays x 12 triangles
    timing = {}
    for key, fn in (
            ("closest", lambda: ci.closest_tris_v(*tris, o, d, 1e-4, 1e30)),
            ("closest_plain",
             lambda: ci.closest_tris_plain(*tris, o, d, 1e-4, 1e30)),
            ("anyhit", lambda: ci.anyhit_tris_v(*tris, o, d, 1e-4, tmax_any)),
            ("anyhit_plain",
             lambda: ci.anyhit_tris_plain(*tris, o, d, 1e-4, tmax_any))):
        timing[key] = cuda_ms(fn, 20)
    # the kernels at the largest soup they take
    for key, fn in (
            ("closest512", lambda: ci.closest_tris_v(*soup, o_r, d_r, 1e-4,
                                                     1e30)),
            ("anyhit512", lambda: ci.anyhit_tris_v(*soup, o_r, d_r, 1e-4,
                                                   1e30))):
        timing[key] = cuda_ms(fn, 5)
    log("[kernels] ms per call at 2^20 rays x 12 tris: "
        + ", ".join(f"{k} {v:.4f}" for k, v in timing.items()
                    if "512" not in k)
        + f"; at 2^20 random rays x 512 tris: closest "
          f"{timing['closest512']:.4f}, anyhit {timing['anyhit512']:.4f}")
    return err_c, err_a, timing


def luminance(img):
    return 0.212671 * img[..., 0] + 0.715160 * img[..., 1] \
        + 0.072169 * img[..., 2]


def main_path_phase(dev):
    scene, settings = tiny_cornell(dev)
    settings.width = settings.height = RES
    settings.spp = SPP
    settings.integrator_props = dict(max_depth=DEPTH)

    ci.reset_launch_counts()
    film = render_film(scene, settings)
    torch.cuda.synchronize()
    launches = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)
    log(f"[main] render_film {RES}x{RES} depth {DEPTH} spp {SPP}: "
        f"closest launches {launches[0]}, anyhit launches {launches[1]}")
    if launches != (DEPTH * SPP, (DEPTH - 1) * SPP):
        raise AssertionError(f"expected {DEPTH} closest and {DEPTH - 1} "
                             f"any-hit launches per pass, got {launches}")

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

    # pass time: difference of two pass counts cancels the fixed costs
    def run(k):
        return lambda: render_film(scene, settings, spp=k)

    k_lo, k_hi = 2, 6
    t_lo = min(cuda_ms(run(k_lo), 1) for _ in range(2))
    t_hi = min(cuda_ms(run(k_hi), 1) for _ in range(2))
    per_pass = (t_hi - t_lo) / (k_hi - k_lo)
    rays = RES * RES * (1 + 2 * (DEPTH - 1))
    log(f"[main] pass time {per_pass:.3f} ms ({k_lo} passes {t_lo:.3f} ms, "
        f"{k_hi} passes {t_hi:.3f} ms); {rays} rays per pass; "
        f"{rays / (per_pass * 1e-3):.4e} rays/s")
    return launches


def cornell_luminance(scene, n_side, skip_direct):
    """parity_check._render_cornell on the port: per-pixel Li sum."""
    s, o, d = camera_rays(scene, n_side, sample=7)
    cfg = PathConfig(max_depth=DEPTH, remat=False, skip_direct=skip_direct)
    li, _ = path_li_v(scene, s, o, d, cfg)
    return (li.x + li.y + li.z).cpu().numpy()


def parity_phase(dev):
    cuda_scene, _ = tiny_cornell(dev)
    cpu_scene, _ = tiny_cornell("cpu")
    for skip in (False, True):
        a = cornell_luminance(cuda_scene, 128, skip)
        b = cornell_luminance(cpu_scene, 128, skip)
        rel_sum = abs(float(a.sum()) - float(b.sum())) / max(abs(float(
            b.sum())), 1e-30)
        scale = max(float(np.abs(b).mean()), 1e-12)
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2 * scale)
        p999 = float(np.quantile(rel, 0.999))
        frac_bad = float((rel > 1e-3).mean())
        ok = rel_sum < 5e-3 and p999 < 1e-3 and frac_bad < 2e-3
        log(f"[parity] 128^2 skip_direct={skip}: cuda {a.sum():.6e} cpu "
            f"{b.sum():.6e} rel {rel_sum:.2e} p999 {p999:.2e} "
            f"frac_bad {frac_bad:.2e} max_rel {rel.max():.2e} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("card vs CPU parity gate failed")


def main():
    smi = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    err_c, err_a, timing = kernel_phase(dev)
    launches = main_path_phase(dev)
    parity_phase(dev)
    kernels = [
        dict(name="tri_closest", route="cuda", source=SOURCE,
             replaces="mitsuba_im_tpu/accel/pallas_intersect.py:79",
             launches=launches[0], max_abs_err=err_c,
             ms=timing["closest"], plain_ms=timing["closest_plain"]),
        dict(name="tri_anyhit", route="cuda", source=SOURCE,
             replaces="mitsuba_im_tpu/accel/pallas_intersect.py:130",
             launches=launches[1], max_abs_err=err_a,
             ms=timing["anyhit"], plain_ms=timing["anyhit_plain"]),
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
