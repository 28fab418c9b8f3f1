#!/usr/bin/env python3
"""Device time of one large-scene pass of the PyTorch/CUDA port, from
``torch.profiler``.

Run from the repository root on a machine with one NVIDIA H100:

    python3 profile_pass.py [--passes N]

Builds ``scenes.large_scene`` (1,120,504 triangles, 768^2, depth 3),
renders one warm-up pass, then ``--passes`` passes under the profiler, and
prints per pass: the device time (the sum of every kernel, copy and set
the card ran), the hierarchy kernels' time and share of it, the profiled
wall time, and the device's idle share (1 - the union of the device
intervals over the span from the first device start to the last device
end).  The profiler slows the host's enqueue, so the idle share under it
is an upper bound of the unprofiled pass's; the device times are not
slowed.  When the profiler records no device activity every number is
printed as "not measured".  The last line is a JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mitsuba_im_tpu_torch.render.job import render_film
from mitsuba_im_tpu_torch.scenes import large_scene


def busy_union(spans):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_pass.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    scene, settings = large_scene("cuda")
    render_film(scene, settings, spp=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_film(scene, settings, spp=args.passes)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    rec = dict(device=smi, passes=args.passes)
    if not dev:
        rec.update(device_ms_per_pass="not measured",
                   hier_share="not measured", idle_share="not measured")
    else:
        spans = [(e.time_range.start, e.time_range.end) for e in dev]
        busy_us = sum(b - a for a, b in spans)
        hier_us = sum(b - a for e, (a, b) in zip(dev, spans)
                      if "hier_kernel" in e.name)
        span_us = max(b for _, b in spans) - min(a for a, _ in spans)
        by_name = {}
        for e, (a, b) in zip(dev, spans):
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        rec.update(
            device_ms_per_pass=busy_us / 1e3 / args.passes,
            hier_ms_per_pass=hier_us / 1e3 / args.passes,
            hier_share=hier_us / busy_us,
            profiled_wall_ms_per_pass=span_us / 1e3 / args.passes,
            idle_share=1.0 - busy_union(spans) / span_us,
            device_ops_per_pass=len(dev) / args.passes,
            top_ms_per_pass=[(k[:80], v / 1e3 / args.passes)
                             for k, v in top])
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
