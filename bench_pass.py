#!/usr/bin/env python3
"""Pass time of one checkout of the PyTorch/CUDA port.

Run on a machine with one NVIDIA H100:

    python3 bench_pass.py [--scene large|cornell] [--root DIR] [--reps N]

Imports ``mitsuba_im_tpu_torch`` from DIR (default: this script's
directory), so that two checkouts can be timed by the same code: unpack
the other one into a directory that ``.gitignore`` lists (``build/``) with
``git archive <commit> | tar -x -C DIR`` and run the script for each in
turns, for example parent, change, change, parent.  Builds the scene of
``--scene`` (``profile_pass.scene_of``): ``scenes.large_scene`` (the
default; 1,120,504 triangles, 768^2, depth 3) or the Cornell box of the
main path (``scenes.tiny_cornell`` at 1024^2, depth 5), renders a
warm-up, then ``--reps`` times renders 1 and 3 passes (``render_film``,
CUDA events around each) and takes the per-pass time from their
difference, as chip_smoke.py does, so fixed costs cancel.  Prints each
per-pass time and their median; the last line is a JSON object.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# imported before --root enters sys.path: scene_of imports the package of
# --root when it is called
from profile_pass import scene_of


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=("large", "cornell"), default="large")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    import mitsuba_im_tpu_torch
    from mitsuba_im_tpu_torch.render.job import render_film

    if Path(mitsuba_im_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {mitsuba_im_tpu_torch.__file__}, not "
                         f"the package under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("bench_pass.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    scene, settings = scene_of(args.scene)
    side = settings.width
    depth = settings.integrator_props["max_depth"]
    rays = side * side * (1 + 2 * (depth - 1))

    def ms(spp):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        render_film(scene, settings, spp=spp)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    ms(1)
    per_pass = []
    for _ in range(args.reps):
        t1, t3 = ms(1), ms(3)
        per_pass.append((t3 - t1) / 2)
    med = statistics.median(per_pass)
    print(f"[pass] {root}: {side}^2 depth {depth}: per-pass ms "
          + ", ".join(f"{v:.3f}" for v in per_pass)
          + f"; median {med:.3f} ms, min {min(per_pass):.3f} ms, "
          f"{rays / (med * 1e-3):.4e} rays/s at the median", flush=True)
    print(json.dumps(dict(device=smi, root=str(root), scene=args.scene,
                          per_pass_ms=per_pass,
                          median_ms=med, min_ms=min(per_pass),
                          rays_per_pass=rays)), flush=True)


if __name__ == "__main__":
    main()
