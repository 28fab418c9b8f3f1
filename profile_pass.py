#!/usr/bin/env python3
"""Device time of one pass of the PyTorch/CUDA port, from
``torch.profiler``.

Run on a machine with one NVIDIA H100:

    python3 profile_pass.py [--scene large|cornell] [--passes N] [--root DIR]

``--scene large`` (the default) builds ``scenes.large_scene`` (1,120,504
triangles, 768^2, depth 3), ``--scene cornell`` the Cornell box of the
main path (``scenes.tiny_cornell``, 12 triangles) at 1024^2, depth 5.
Imports ``mitsuba_im_tpu_torch`` from DIR (default: this script's
directory), so that two checkouts are profiled by the same code (see
bench_pass.py).  Renders one warm-up pass, then ``--passes`` passes under
the profiler, and prints per pass: the device time (the sum of every
kernel, copy and set the card ran), the scene's intersection kernels' time
and share of it (the hierarchy kernels for the large scene, the
brute-force kernels for the Cornell box), the device operations, the
profiled wall time, and the device's idle share (1 - the union of the
device intervals over the span from the first device start to the last
device end).  The profiler slows the host's enqueue, so the idle share
under it is an upper bound of the unprofiled pass's; the device times are
not slowed.  When the profiler records no device activity every number is
printed as "not measured".  The last line is a JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# name fragments of each scene's intersection kernels
KERNELS = {"large": ("hier_kernel",),
           "cornell": ("closest_kernel", "anyhit_kernel")}


def busy_union(spans):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def scene_of(name):
    """(scene, settings) of the named configuration on the card."""
    from mitsuba_im_tpu_torch.scenes import large_scene, tiny_cornell

    if name == "large":
        return large_scene("cuda")
    scene, settings = tiny_cornell("cuda")
    settings.width = settings.height = 1024
    settings.integrator_props = dict(max_depth=5)
    return scene, settings


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=sorted(KERNELS), default="large")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import mitsuba_im_tpu_torch
    from mitsuba_im_tpu_torch.render.job import render_film

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

    scene, settings = scene_of(args.scene)
    render_film(scene, settings, spp=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_film(scene, settings, spp=args.passes)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    rec = dict(device=smi, root=str(root), scene=args.scene,
               passes=args.passes)
    if not dev:
        rec.update(device_ms_per_pass="not measured",
                   kernel_share="not measured", idle_share="not measured")
    else:
        spans = [(e.time_range.start, e.time_range.end) for e in dev]
        busy_us = sum(b - a for a, b in spans)
        kern_us = sum(b - a for e, (a, b) in zip(dev, spans)
                      if any(k in e.name for k in KERNELS[args.scene]))
        span_us = max(b for _, b in spans) - min(a for a, _ in spans)
        by_name = {}
        for e, (a, b) in zip(dev, spans):
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        rec.update(
            device_ms_per_pass=busy_us / 1e3 / args.passes,
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
