#!/usr/bin/env python3
"""Device time of one pass of the PyTorch/CUDA port, from
``torch.profiler``.

Run on a machine with one NVIDIA H100:

    python3 profile_pass.py [--scene large|cornell|textured|lights]
                            [--grad] [--per-lane-index] [--passes N]
                            [--root DIR]

``--scene large`` (the default) builds ``scenes.large_scene`` (1,120,504
triangles, 768^2, depth 3), ``--scene cornell`` the Cornell box of the
main path (``scenes.tiny_cornell``, 12 triangles) at 1024^2, depth 5,
``--scene textured`` ``scenes.textured_cornell`` (1024^2, depth 5, ray
differentials on), ``--scene lights`` ``scenes.lights_cornell`` (1024^2,
depth 5, 4 spp of ldsampler, the Gaussian filter, a thin lens).
``--per-lane-index`` makes every sampler compute the words that depend on
the sample index alone per lane, as it does when the lanes do not share
one, in place of the host's once-per-pass words; with ``--scene lights``
the record also holds one ldsampler block at 2^20 lanes (device
operations, device ms), so two runs with and without the option compare
both paths.
Imports ``mitsuba_im_tpu_torch`` from DIR (default: this script's
directory), so that two checkouts are profiled by the same code (see
bench_pass.py).  Renders one warm-up pass, then ``--passes`` passes under
the profiler, and prints per pass: the device time (the sum of every
kernel, copy and set the card ran), the scene's intersection kernels' time
and share of it (the hierarchy kernels for the large scene, the
brute-force kernels for the Cornell box), the device operations, the
profiled wall time, the peak of allocated device memory over the warm-up
and the profiled passes, and the device's idle share (1 - the union of the
device intervals over the span from the first device start to the last
device end).  The profiler slows the host's enqueue, so the idle share
under it is an upper bound of the unprofiled pass's; the device times are
not slowed.  When the profiler records no device activity every number is
printed as "not measured".  ``wall_ms_per_pass`` is the unprofiled
median of three timed runs of ``--passes`` passes.  ``--grad`` profiles fwd+bwd passes instead (d
sum(Li)/d params of one sample per pixel through
``diff.optimize.render_rays``, path replay): the Cornell box in
bench.py's fwd+bwd configuration (``remat_group=4``, d/d ``bsdf.refl``;
the textured box d/d ``texture.atlas`` and ``emitter.radiance``, without
ray differentials, as ``render_rays`` traces), the large scene with
per-bounce replay (d/d ``bsdf.alpha`` and ``emitter.radiance``); it adds
the share of the backward's scatter-adds into the scene tables
(``index_put`` kernels). The last line is a JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# name fragments of each scene's intersection kernels
KERNELS = {"large": ("hier_kernel",),
           "cornell": ("closest_kernel", "anyhit_kernel"),
           "textured": ("closest_kernel", "anyhit_kernel"),
           "lights": ("closest_kernel", "anyhit_kernel")}
# the gradients of --grad, and the kernels of the backward's gathers
GRAD_LABELS = {"large": ("bsdf.alpha", "emitter.radiance"),
               "cornell": ("bsdf.refl",),
               "textured": ("texture.atlas", "emitter.radiance"),
               "lights": ("bsdf.refl", "emitter.radiance")}
SCATTER = ("index_put", "indexing_backward")


def busy_union(spans):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_events(run, passes):
    """The device events (kernels, copies, sets) of ``run(passes)`` under
    torch.profiler; the caller has warmed ``run`` up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(passes)
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_us(events, names=None):
    """Summed device time (us) of the events whose name holds one of
    ``names`` (of every event when None)."""
    return sum(e.time_range.end - e.time_range.start for e in events
               if names is None or any(k in e.name for k in names))


def lds_block(torch, n=1 << 20, reps=4):
    """Device operations and device ms of one ldsampler block at ``n``
    lanes sharing a sample index (under torch.profiler)."""
    from mitsuba_im_tpu_torch.core import rng

    pix = torch.arange(n, dtype=torch.int64, device="cuda")
    s = rng.make_sampler_v(pix, 5, 77, kind=rng.LDSAMPLER, spp=4)
    rng.next_block4_v(s)
    ev = device_events(lambda k: [rng.next_block4_v(s) for _ in range(k)],
                       reps)
    if not ev:
        return dict(block_ops="not measured", block_device_ms="not measured")
    return dict(block_ops=len(ev) / reps,
                block_device_ms=device_us(ev) / 1e3 / reps)


def scene_of(name):
    """(scene, settings) of the named configuration on the card."""
    from mitsuba_im_tpu_torch.scenes import (large_scene, lights_cornell,
                                             textured_cornell, tiny_cornell)

    if name == "large":
        return large_scene("cuda")
    if name == "lights":
        return lights_cornell("cuda")
    if name == "textured":
        return textured_cornell("cuda")
    scene, settings = tiny_cornell("cuda")
    settings.width = settings.height = 1024
    settings.integrator_props = dict(max_depth=5)
    return scene, settings


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=sorted(KERNELS), default="large")
    ap.add_argument("--grad", action="store_true",
                    help="profile fwd+bwd passes (path replay)")
    ap.add_argument("--per-lane-index", action="store_true",
                    help="the sample index's words per lane, not once on "
                    "the host")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    import mitsuba_im_tpu_torch
    from mitsuba_im_tpu_torch.render.job import path_config, render_film

    if Path(mitsuba_im_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {mitsuba_im_tpu_torch.__file__}, not "
                         f"the package under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_pass.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    if args.per_lane_index:
        from mitsuba_im_tpu_torch.core import rng

        rng._index_parts = lambda s: rng._index_words(s.sample, s.kind,
                                                      s.spp)
    scene, settings = scene_of(args.scene)
    if args.grad:
        from mitsuba_im_tpu_torch.diff import optimize as opt

        cfg = dataclasses.replace(path_config(settings), remat=True,
                                  remat_group=1 if args.scene == "large"
                                  else 4)
        labels = GRAD_LABELS[args.scene]
        pix = torch.arange(settings.width * settings.height,
                           device=scene.device)

        def run(passes):
            for s in range(passes):
                params = {k: v.detach().clone().requires_grad_(True)
                          for k, v in opt.get_params(scene, labels).items()}
                opt.render_rays(opt.set_params(scene, params), settings, cfg,
                                pix, s, 0).sum().backward()
    else:
        def run(passes):
            render_film(scene, settings, spp=passes)
    torch.cuda.reset_peak_memory_stats()
    run(1)
    dev = device_events(run, args.passes)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(args.passes)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / args.passes)
    rec = dict(device=smi, root=str(root), scene=args.scene,
               grad=args.grad, per_lane_index=args.per_lane_index,
               passes=args.passes, peak_gib=peak_gib,
               wall_ms_per_pass=statistics.median(walls))
    if args.scene == "lights":
        rec.update(lds_block(torch))
    if not dev:
        rec.update(device_ms_per_pass="not measured",
                   kernel_share="not measured", idle_share="not measured",
                   scatter_share="not measured")
    else:
        spans = [(e.time_range.start, e.time_range.end) for e in dev]
        busy_us = device_us(dev)
        kern_us = device_us(dev, KERNELS[args.scene])
        span_us = max(b for _, b in spans) - min(a for a, _ in spans)
        by_name = {}
        for e, (a, b) in zip(dev, spans):
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        scatter_us = device_us(dev, SCATTER)
        rec.update(
            device_ms_per_pass=busy_us / 1e3 / args.passes,
            scatter_ms_per_pass=scatter_us / 1e3 / args.passes,
            scatter_share=scatter_us / busy_us,
            kernels=KERNELS[args.scene],
            kernel_ms_per_pass=kern_us / 1e3 / args.passes,
            kernel_share=kern_us / busy_us,
            profiled_wall_ms_per_pass=span_us / 1e3 / args.passes,
            idle_share=1.0 - busy_union(spans) / span_us,
            device_ops_per_pass=len(dev) / args.passes,
            top_ms_per_pass=[(k[:80], v / 1e3 / args.passes)
                             for k, v in top])
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
