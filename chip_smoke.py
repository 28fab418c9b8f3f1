#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mitsuba_im_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero:

1. device: require CUDA, print the card's name and power limit, turn TF32
   off;
2. build: compile ``csrc/tri_intersect.cu`` and ``csrc/hier_traverse.cu``
   with nvcc and ``csrc/bvh_build.cpp`` and ``csrc/alias_build.cpp`` with
   the host C++ compiler, all four at once (each timed; ptxas register
   and spill report, each kernel named);
3. brute-force kernels vs their plain PyTorch versions on the card, bit
   for bit: 2^20 camera rays into the Cornell soup and into
   material_cornell's (272 triangles, phase 12's path), and 2^20 random
   rays into a random 512-triangle soup, with numbers and with tensors for
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
   parity_check.py's gate;
9. the Cornell fwd+bwd pass, bench.py's configuration: 1024^2, depth 5,
   ``remat=True, remat_group=4``, d sum(Li)/d ``bsdf.refl`` and d
   sum(Li)/d ``emitter.radiance`` (``diff.optimize.render_rays``, sample
   0): 5 closest + 4 any-hit launches forward and 9 + 8 with the backward
   pass's replay; every gradient finite; the refl gradient positive on
   the three wall rows; radiance linearity (the one area light is the
   only emitter and roulette never fires at depth 5, so d sum(Li)/d
   radiance[c] = sum(Li_c)/radiance[c], rel < 1e-3); peak device memory
   of remat_group 4, per-bounce remat and remat=False, and their
   gradients' max rel difference (< 1e-5); the fwd+bwd pass time from
   differencing two pass counts and its ratio to phase 4's pass;
10. card vs CPU gradient: parity_check._grad_cornell's configuration
   (128^2, depth 5, per-bounce remat, sample 7, d sum(Li)/d refl), max
   |g_card - g_cpu| / max |g_cpu| < 5e-3;
11. the large scene's gradient: 768^2, depth 3, per-bounce remat, d
   sum(Li)/d ``bsdf.alpha`` (which moves ray directions) and d sum(Li)/d
   ``emitter.radiance``: 3 + 2 hierarchy launches forward and 5 + 4 with
   the replay, no brute-force launch; finite; a non-zero alpha gradient on
   the mesh's BSDF; radiance linearity (the unit constant environment is
   the only emitter); peak device memory and the fwd+bwd pass time;
12. the thirteen new BSDF families and the environment map:
   ``render_film`` on ``scenes.material_cornell("cuda")`` (272 triangles,
   the area light and a Hosek sky) at 1024^2, depth 5, 4 spp; 5 closest and
   4 any-hit launches per pass, no hierarchy launch; the image finite and
   non-negative; the pass time from differencing two pass counts; device
   operations, device time and idle share per pass (torch.profiler);
13. card vs CPU on material_cornell at 128^2, depth 5: parity_check.py's
   gate;
14. the large scene under the Hosek sky (``large_scene("cuda",
   env="sky")``, bench.py's third metric with a baked sky in place of its
   envmap file) at 768^2, depth 3, 2 spp: 3 + 2 hierarchy launches per
   pass, no brute-force launch; the image finite, its corners the sky's
   (not the unit environment's 1.0, not all alike, the top ones lit); the
   pass time,
   peak device memory, device operations per pass;
15. card vs CPU on the sky scene at 64^2, depth 3: parity_check.py's gate;
16. the material_cornell gradient at 128^2, depth 5, ``remat_group=4``, d
   sum(Li)/d refl, spec, alpha and the radiance of both emitters: finite;
   radiance linearity over both emitters (roulette never fires at depth 5,
   so sum_e radiance_e d sum(Li_c)/d radiance_e = sum(Li_c), rel < 1e-3);
   card vs CPU max rel < 5e-3 for each; the fwd+bwd pass time;
17. textures: ``render_film`` on ``scenes.textured_cornell("cuda")`` (a
   2048^2 bitmap with its MIP pyramid, 1024^2 height and normal maps, a
   checkerboard, a grid, a scale, MASK and BLEND wrappers, ``alpha_tex``;
   32 triangles) at 1024^2, depth 5, 4 spp, with the primary rays'
   differentials filtering the bitmaps; 5 closest and 4 any-hit launches
   per pass, no hierarchy launch; the texture count and atlas MiB; the
   image finite, non-negative, of plausible brightness; the pass time,
   peak device memory, device operations, device time and idle share;
18. card vs CPU on textured_cornell at 128^2, depth 5, filtered:
   parity_check.py's gate;
19. the large scene with a seeded 2048^2 bitmap on its mesh (spherical
   uvs; ``large_scene("cuda", texture=True)``) at 768^2, depth 3, 2 spp: 3
   + 2 hierarchy launches per pass, no brute-force launch; the pass time,
   peak device memory; card vs CPU at 64^2 (filtered) under the gate;
20. the atlas gradient, bench.py's fwd+bwd configuration on
   textured_cornell (1024^2, depth 5, ``remat_group=4``): d sum(Li)/d
   ``texture.atlas`` and d sum(Li)/d ``emitter.radiance``; 5 + 4 launches
   forward and 9 + 8 with the replay; finite; non-zero on the bitmap's
   texels; radiance linearity (the area light is the only emitter); peak
   device memory; the fwd+bwd pass time and its ratio to phase 17's pass;
   the share of a pass's device time in the gathers' backward
   (``index_put``/``indexing_backward``); card vs CPU atlas gradient at
   64^2, max rel < 5e-3;
21. samplers: every kind (independent, stratified, ldsampler, sobol,
   halton, hammersley) on the card against the same call on the CPU, bit
   for bit: 2^20 lanes x 6 blocks of ``next_block4_v`` with the shared
   sample index of a render pass, and 2^16 lanes with an index per lane;
   device operations and card ms of one block at 2^20 lanes;
22. lights: ``render_film`` on ``scenes.lights_cornell("cuda")`` (the
   Cornell box's triangle light, an analytic sphere and a disk area
   light, a point, a spot and a collimated beam; a thin lens; ldsampler;
   the Gaussian filter of radius 2) at 1024^2, depth 5, 4 spp: 5 closest
   and 4 any-hit launches per pass, no hierarchy launch; the image finite
   and non-negative; the pass time, device operations, device time, idle
   share and peak memory; the pass time and device operations of
   ldsampler/independent x Gaussian/box, timed in turns; at 128^2 each
   light alone lights the image (the collimated beam alone leaves it
   black, as in the reference);
23. card vs CPU on lights_cornell at 128^2, depth 5, then at 64^2, depth
   3, one option at a time: each of the 7 sensor types, 6 samplers and 6
   filters, all through ``render_film`` under parity_check.py's gate;
24. the large scene under the Preetham sky and the sun
   (``large_scene("cuda", env="sunsky")``: sobol, the Mitchell filter) at
   768^2, depth 3, 2 spp: 3 + 2 hierarchy launches per pass, no
   brute-force launch; the image finite; 18 pixels of its top rows, which
   see the sky, the sky map's radiance toward them (within 5%, the sky
   positive at each); the pass time, device operations,
   peak memory; card vs CPU at 64^2 under the gate;
25. the lights_cornell gradient at 128^2, depth 5, ``remat_group=4``: d
   sum(Li)/d ``bsdf.refl`` and ``emitter.radiance``; 5 + 4 launches
   forward and 9 + 8 with the replay; finite; card vs CPU max rel < 5e-3;
26. ``[xml cornell]``: tests/test_render.py's Cornell box as a scene file
   (six ``rectangle`` shapes, the area light, the box filter) through the
   port's command line (``cli.main.main``) at 1024^2, depth 5, 4 spp:
   the scene file's load and build seconds; 5 closest and 4 any-hit
   launches per pass; the EXR and the PNG it writes read back by the
   port's codecs, red on the left and green on the right; its film (the
   checkpoint of ``-c``) bit for bit the film of ``render_film`` called
   directly on the loaded scene; ``-s 2 -c`` then ``-z`` to 4 spp bit for
   bit the uninterrupted film (the box splat sums a pixel's samples in
   sample order, ``film/film.py``); the pass time; card vs CPU at 128^2
   under the gate;
27. ``[xml large]``: the 1,120,504-triangle displaced sphere written as a
   binary little-endian PLY with normals and uvs, under an ``envmap``
   read from an EXR that the port's ``write_exr`` wrote from the Hosek
   sky (resolution 512), GGX rough copper (alpha 0.2), through the command
   line at 768^2, depth 3, 2 spp: the seconds of the PLY load, the EXR
   read, the hierarchy build and the whole load; 3 + 2 hierarchy launches
   per pass and no brute-force launch; the top-row pixels lit by the map;
   the pass time and peak device memory; card vs CPU at 64^2 under the
   gate;
28. ``[xml plugins]``: three small scene files (meshes: ``obj``,
   ``serialized`` written by ``save_serialized``, ``cube``, ``cylinder``;
   textures: a PNG ``bitmap`` and ``curvature``; lights: ``blackbody`` and
   ``spectrum`` values, and an ``ldrfilm`` whose command-line PNG is
   Reinhard tone mapped) at 64^2, depth 3, card vs CPU under the gate;
29. ``[motion large]``: the large scene's mesh as a deformable, frame 1
   moved a fifth of its radius along x, shutter 0-1: both hierarchy
   kernels' motion mode bit for bit with the plain version on the 768^2
   camera rays and their shadow rays at t = 0, 0.37 and 1, and with the
   static kernel on frame 0's rows at t = 0; the motion mode and the static
   mode on the same tables timed in turns (events and the profiler's device
   ms, median of 11) with the motion mode's bound (both row tables read
   once, the lerp's flops once a cluster row); ``render_film`` at 768^2, depth 3, 2 spp with 3 + 2
   motion launches a pass; card vs CPU at 64^2, 2 spp;
30. ``[motion cornell]``: the Cornell box with a deformable quad sliding
   across it, 1024^2, depth 5, 4 spp, 5 + 4 brute-force launches a pass on
   the lerped tables, the image moved from frame 0's; card vs CPU at 128^2;
31. ``[instanced]``: a shapegroup of the 1,120,504-triangle mesh instanced
   4 x 4 (17.9M triangles seen): the kernels bit for bit on its camera
   rays, 768^2, depth 3, 2 spp with 3 + 2 hierarchy launches a pass, peak
   memory, card vs CPU at 64^2; 4 instances of a 100k-triangle mesh
   against the same scene expanded, on the card, under the gate;
32. ``[irawan]``: the Cornell box with the plain weave on the floor and a
   twill on the back wall, 1024^2, depth 5, 4 spp: launches, the pass
   time, device operations a pass, card vs CPU at 128^2;
33. ``[integrators]``: ``direct`` (2 + 2 samples), ``ao`` (4), every
   ``field`` name and ``motion`` through the command line on the XML
   Cornell at 1024^2, 4 spp, and ``direct`` and ``ao`` on phase 27's large
   scene at 768^2: launches a pass (direct 3 + 2, ao 1 + 4, the others
   1 + 0), the pass time, card vs CPU;
34. ``[tiled]``: the XML Cornell with ``tiledhdrfilm`` at 4096^2 through the
   command line in bands of 64 rows (render_tiled's default): seconds, launches and peak memory
   against one full-frame 4096^2 pass; at 1024^2 the tiled film (full
   precision) within 2e-5 of ``render_film``'s;
35. ``[volume cornell]``: ``volume_cornell`` (three icosahedra: a null
   boundary around a homogeneous HG medium, one around a 128^3 grid medium
   with a microflake phase along a swirl, a dielectric around a Kajiya-Kay
   medium; the camera in a fog with a mixture phase) through
   ``render_film`` with ``volpath`` at 1024^2, depth 5, 2 spp: 25
   brute-force closest-hit launches a pass (a camera segment and four
   shadow segments a bounce), no any hit; the tracking loops' iterations
   and host syncs a pass, the pass time, device operations, device time,
   idle share and peak memory; ``tri_closest`` bit for bit with its plain
   version on the first bounce's shadow segments (a per-ray tmax); the
   same scene as a file (OBJ icosahedra, .vol grids) through the command
   line at 256^2, 25 + 0 launches, its EXR render_film's film; card vs CPU
   at 128^2;
36. ``[volume large]``: ``volume_large`` (the 1,120,504-triangle mesh as a
   null boundary around a homogeneous medium) at 768^2, depth 3, 2 spp:
   15 ``hier_closest`` launches a pass, no any hit; the same measurements;
   ``hier_closest`` bit for bit on the first bounce's shadow segments;
   card vs CPU at 128^2;
37. ``[ptracer cornell]``: the particle tracer (``job.render``) on the
   Cornell box at 1024^2, depth 5, 2^20 particles a pass, 4 passes: 5
   closest-hit and 5 any-hit launches a pass, no hierarchy launch; the
   image plausible (red left, green right); the pass time in turns,
   device operations, device time, idle share, peak memory; both
   brute-force kernels bit for bit on the first bounce's camera
   connections; card vs CPU at 128^2; its 128^2 mean within 5% of the
   card's ``path``;
38. ``[ptracer lights]``: ``lights_cornell`` (every emitter kind of the
   scene a particle origin) at 128^2, card vs CPU;
39. ``[bdpt cornell]``: bdpt on the Cornell box at 1024^2, depth 5, 4 spp,
   the light image on: 9 closest-hit and 14 any-hit launches a pass; the
   same measurements; both kernels bit for bit on the first inner
   connection's segments; card vs CPU at 128^2; its 128^2 mean within 5%
   of the card's ``path``, each channel within 8%;
40. ``[bdpt large]``: bdpt on the 1,120,504-triangle scene at 768^2, depth
   3, 2 spp: 5 ``hier_closest`` and 5 ``hier_anyhit`` launches a pass, no
   brute-force launch; the pass time, device profile, peak memory; both
   hierarchy kernels bit for bit on its inner connection's segments; card
   vs CPU at 64^2;
41. ``[bdpt volume]``: bdpt on ``volume_cornell`` at 128^2, depth 5: card vs
   CPU; at 1024^2 (2 passes against volpath's 4: a pass is host-bound on
   the tracking loops, so the samples come from lanes), its mean within
   5% of the card's ``volpath`` over the image and inside the Kajiya-Kay
   icosahedron; the tracking loops' iterations and host syncs a pass;
42. ``[sppm cornell]``: sppm (``job.render``) on the Cornell box at
   1024^2, 250,000 photons of 8 bounces, 4 passes: 15 closest-hit
   launches a pass, no any hit; the gather's chunks, pairs and kept pairs
   a pass; the pass time (CUDA events), device operations, device time,
   idle share, peak memory; both brute-force kernels bit for bit on the
   photons' rays from the light and their first bounce; card vs CPU at
   128^2 (20,000 photons a pass); its 128^2 mean within 12% of the card's
   path;
43. ``[sppm volume]``: sppm on ``volume_cornell`` at 128^2 (volume photons
   in its homogeneous media, the beam estimate in the fog), card vs CPU;
44. ``[sppm large]``: sppm on the 1,120,504-triangle scene at 768^2, depth
   3, 2 passes: 10 ``hier_closest`` launches a pass, no brute-force
   launch; the same measurements; both hierarchy kernels bit for bit on
   the photons' first two rays; card vs CPU at 64^2;
45. ``[vpl cornell]``: vpl at 1024^2, 256 light paths, depth 5 (768 VPLs a
   pass), 2 passes: 8 closest-hit and 49 any-hit launches a pass (16 VPLs
   a wavefront); both brute-force kernels bit for bit on the first VPL
   wavefront's shadow rays; card vs CPU at 128^2; its mean within 10% of
   path's at depth 5;
46. ``[irrcache cornell]``: irrcache at 1024^2, 65,536 records (stride 4;
   256 dense, the rest in the hash grid), 588 hemisphere samples of the
   nested path at depth 3, 1 spp: launches, the record split; card vs CPU
   at 128^2; its mean within 20% of path's at depth 6;
47. ``[adaptive cornell]``: adaptive at 1024^2, rounds of 4 samples,
   maxError 0.05, at most 32 rounds, the nested path at depth 5: the
   active pixels of each round, 5 + 4 launches a sample; card vs CPU at
   128^2; its mean within 15% of path's;
48. ``[multichannel]``: path and field shapeIndex from a scene file through
   the command line at 1024^2: the EXR's six layers read back, the path
   layer path's own render; card vs CPU at 128^2.

Every phase logs its seconds (``[seconds] name: s``).  The next-to-last
line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import json
import os
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mitsuba_im_tpu_torch.cli import main as cli_main
from mitsuba_im_tpu_torch.accel import bvh
from mitsuba_im_tpu_torch.accel import cuda_hierarchy as ch
from mitsuba_im_tpu_torch.accel import cuda_intersect as ci
from mitsuba_im_tpu_torch.accel import hierarchy as hy
from mitsuba_im_tpu_torch.accel import intersect as isect
from mitsuba_im_tpu_torch.core import distribution as dist
from mitsuba_im_tpu_torch.core import rng
from mitsuba_im_tpu_torch.core.types import EPSILON, SHADOW_EPSILON, Int
from mitsuba_im_tpu_torch.core.v3 import V3
from mitsuba_im_tpu_torch.diff.optimize import get_params, render_rays, \
    set_params
from mitsuba_im_tpu_torch.core.transform import Transform
from mitsuba_im_tpu_torch.emitter.table import (EM_DIRECTIONAL,
                                                eval_environment_v)
from mitsuba_im_tpu_torch.film.film import F_BOX, FILTER_NAMES, develop
from mitsuba_im_tpu_torch.io import bitmap, exr, png
from mitsuba_im_tpu_torch.integrators import adaptive, irrcache, sppm, vpl
from mitsuba_im_tpu_torch.integrators.path import PathConfig, path_li_v
from mitsuba_im_tpu_torch.integrators.volpath import MAX_NULL_SEGMENTS
from mitsuba_im_tpu_torch.media import medium as med
from mitsuba_im_tpu_torch.render import job
from mitsuba_im_tpu_torch.render.job import render_film
from mitsuba_im_tpu_torch.render.raydiff import camera_ray_differentials
from mitsuba_im_tpu_torch.sampler import KIND_BY_NAME
from mitsuba_im_tpu_torch.integrators.simple import FIELDS
from mitsuba_im_tpu_torch.scenes import (CORNELL_CAMERA, LIGHTS, LIGHTS_LENS,
                                         MOTION_SHIFT, instanced_scene,
                                         irawan_cornell, large_scene,
                                         lights_cornell, material_cornell,
                                         motion_cornell, textured_cornell,
                                         tiny_cornell, volume_cornell,
                                         volume_large, volume_records,
                                         icosahedron, VOLUME_CENTRES,
                                         VOLUME_RADIUS)
from mitsuba_im_tpu_torch.media.volume import write_vol
from mitsuba_im_tpu_torch.scenes import LARGE_CAMERA, SUN_DIR, displaced_sphere
from mitsuba_im_tpu_torch.emitter import hosek
from mitsuba_im_tpu_torch.scene import build as scene_build
from mitsuba_im_tpu_torch.scene import mesh as mesh_mod
from mitsuba_im_tpu_torch.scene import xml as scene_xml
from mitsuba_im_tpu_torch.sensor.table import (connect_v, make_sensor,
                                               sample_ray_v)
from profile_pass import SCATTER, busy_union, device_events, device_us
from tri_sass import ISSUE_PER_S, issue_floor_ms, kernel_costs, sass_text

RES = 1024
DEPTH = 5
SPP = 4
N_RAYS = 1 << 20
TRI_KERNELS = ("closest_kernel", "anyhit_kernel")
HIER_KERNELS = ("hier_kernel",)
TRI_SOURCE = "mitsuba_im_tpu_torch/csrc/tri_intersect.cu"
HIER_SOURCE = "mitsuba_im_tpu_torch/csrc/hier_traverse.cu"
HIER_REPLACES = ("mitsuba_im_tpu/accel/hier_kernel.py:81, "
                 "mitsuba_im_tpu/accel/hier_kernel.py:285, "
                 "mitsuba_im_tpu/accel/hier_kernel.py:439")
# the motion mode: the XLA driver's lerp that it ports, in the kernels
# above
HIER_MOTION_REPLACES = ("mitsuba_im_tpu/accel/hierarchy.py:573 (the lerp "
                        "of the XLA driver; the Pallas kernels of "
                        "mitsuba_im_tpu/accel/hier_kernel.py:81, :285, :439 "
                        "have no motion mode)")
L_RES = 768  # the large scene
L_DEPTH = 3
L_SPP = 2
G_LABELS = ("bsdf.refl", "emitter.radiance")  # the Cornell gradients
M_LABELS = ("bsdf.refl", "bsdf.spec", "bsdf.alpha", "emitter.radiance")
M_GRAD_RES = 128  # the material_cornell gradient
T_LABELS = ("texture.atlas", "emitter.radiance")  # the textured gradient
T_GRAD_PARITY_RES = 64
SWEEP_RES = 64  # the lights_cornell sweep of sensors, samplers and filters
SWEEP_DEPTH = 3
N_BLOCKS = 6  # sampler blocks checked card vs CPU

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
            "bvh_build.cpp": bvh.LIBRARY, "alias_build.cpp": dist.LIBRARY,
            "obj_load.cpp": mesh_mod.OBJ_LIBRARY}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.load) for lib in libs.values()]:
            f.result()
    log(f"[build] all libraries ready in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        log(f"[build] {name}: {lib.path().name}, compiler "
            f"{lib.seconds:.2f} s")
        for line in lib.log.splitlines():
            if any(k in line for k in ("registers", "smem", "spill",
                                       "Function properties")):
                log(f"[build]   {line.strip()}")


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds of fn() over reps calls (CUDA events; one call
    first to warm up, unless ``warm`` is False)."""
    if warm:
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


def device_ms_in_turns(fns, reps, names=TRI_KERNELS, rounds=None):
    """{name: median device ms of the kernel that each fn launches, named
    with one of ``names``}: torch.profiler's kernel durations, the
    functions in turns, ``reps`` rounds after a warm-up.  Each round is a
    profiler session of its own that calls the functions twice: the
    profiler can miss the first kernels of a session (it did when they
    ran for milliseconds), so the second pass is timed, its kernels the
    last ``len(fns)`` recorded, in the order of the calls.  A round is left
    out (logged) when fewer were recorded, or when the first pass's
    recorded kernels do not match the second's by name.  None for each
    function when no round was kept.  ``rounds``, a dict, takes each
    function's kept rounds (ms)."""
    def run(passes):
        for _ in range(passes):
            for fn in fns.values():
                fn()
            torch.cuda.synchronize()

    run(1)
    n = len(fns)
    times = {k: [] for k in fns}
    left_out = []
    for _ in range(reps):
        ev = sorted((e for e in device_events(run, 2)
                     if any(s in e.name for s in names)),
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
    if rounds is not None:
        rounds.update(times)
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


def camera_rays(scene, n_side, sample=0, diffs=False):
    """(sampler, o, d) of one sample per pixel, and with ``diffs`` the
    rays' differentials for +1-pixel offsets."""
    n = n_side * n_side
    pix = torch.arange(n, dtype=torch.int64, device=scene.device)
    s = rng.make_sampler_v(pix, sample, 0)
    s, blk = rng.next_block4_v(s)
    uu = ((pix % n_side).float() + blk[0]) / n_side
    vv = ((pix // n_side).float() + blk[1]) / n_side
    o, d, _ = sample_ray_v(scene.sensor, uu, vv, blk[2], blk[3])
    if not diffs:
        return s, o, d
    return s, o, d, camera_ray_differentials(
        scene.sensor, uu, vv, blk[2], blk[3], 1.0 / n_side, 1.0 / n_side)


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
    """{name: dict(geom, o, d, forms, tmax)}: the Cornell box's geometry,
    material_cornell's (272 triangles) and textured_cornell's (32), each
    with the 2^20 camera rays of a 1024^2 image, and a random 512-triangle
    soup (in the Cornell geometry's place, no sphere or disk) with 2^20
    random rays; ``tmax`` is the (N,) any-hit tmax timed."""
    scene, _ = tiny_cornell(dev)
    mscene, _ = material_cornell(dev)
    tscene, _ = textured_cornell(dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    _, o, d = camera_rays(scene, RES)
    _, o_m, d_m = camera_rays(mscene, RES)
    _, o_t, d_t = camera_rays(tscene, RES)
    (p0, e1, e2), o_r, d_r = random_soup(gen, ci.MAX_TRIS, N_RAYS, dev)
    soup = dataclasses.replace(
        scene.geom, tri_p0=p0, tri_e1=e1, tri_e2=e2, n_tris=ci.MAX_TRIS,
        tri_shape=torch.randint(0, 9, (ci.MAX_TRIS,), generator=gen,
                                device=dev, dtype=Int))
    out = {}
    for name, geom, oo, dd in (("cornell", scene.geom, o, d),
                               ("material_cornell", mscene.geom, o_m, d_m),
                               ("textured_cornell", tscene.geom, o_t, d_t),
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


def pass_time(scene, settings, k_lo, k_hi, rays, tag="main"):
    """Per-pass ms from differencing two pass counts (cancels the fixed
    costs), as bench.py does."""
    def run(k):
        return lambda: render_film(scene, settings, spp=k)

    run(1)()  # warm up once; each count is then timed twice
    t_lo = min(cuda_ms(run(k_lo), 1, warm=False) for _ in range(2))
    t_hi = min(cuda_ms(run(k_hi), 1, warm=False) for _ in range(2))
    per_pass = (t_hi - t_lo) / (k_hi - k_lo)
    log(f"[{tag}] pass time {per_pass:.3f} ms ({k_lo} passes {t_lo:.3f} ms, "
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
    per_pass = pass_time(scene, settings, 2, 6,
                         RES * RES * (1 + 2 * (DEPTH - 1)))
    return launches, per_pass


def parity_stats(a, b):
    """parity_check.py:137's gate of per-pixel values a against b: the
    sum's rel, the per-pixel rel's 99.9th percentile and the share of
    pixels (``bad`` per pixel) above 1e-3."""
    rel_sum = abs(float(a.sum()) - float(b.sum())) / max(abs(float(
        b.sum())), 1e-30)
    scale = max(float(np.abs(b).mean()), 1e-12)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2 * scale)
    p999 = float(np.quantile(rel, 0.999))
    bad = rel > 1e-3
    frac_bad = float(bad.mean())
    return dict(rel=rel_sum, p999=p999, frac_bad=frac_bad, bad=bad,
                max_rel=float(rel.max()),
                ok=rel_sum < 5e-3 and p999 < 1e-3 and frac_bad < 2e-3)


def parity_gate(name, a, b):
    st = parity_stats(a, b)
    ok = st["ok"]
    log(f"[parity] {name}: cuda {a.sum():.6e} cpu {b.sum():.6e} rel "
        f"{st['rel']:.2e} p999 {st['p999']:.2e} frac_bad "
        f"{st['frac_bad']:.2e} max_rel {st['max_rel']:.2e} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("card vs CPU parity gate failed")


def path_luminance(scene, n_side, depth, skip_direct=False, diffs=False):
    """parity_check._render_cornell on the port: per-pixel Li sum (with
    ``diffs``, the primary rays' differentials filter the bitmaps)."""
    s, o, d, *dd = camera_rays(scene, n_side, sample=7, diffs=diffs)
    cfg = PathConfig(max_depth=depth, remat=False, skip_direct=skip_direct)
    kw = dict(dddx=dd[0][0], dddy=dd[0][1]) if diffs else {}
    li, _ = path_li_v(scene, s, o, d, cfg, **kw)
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
    calls = {"closest": lambda: ch.hier_closest(h, o, d, EPSILON, 1e30),
             "anyhit": lambda: ch.hier_anyhit(h, p, w, EPSILON, tmax,
                                              found)}
    timing = median_ms_in_turns(calls, 11)
    for k, v in device_ms_in_turns(calls, 11, names=HIER_KERNELS).items():
        timing[f"{k}_device"] = v
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
        + ", ".join(f"{k} {fmt(v)}" for k, v in timing.items()
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


# ---------------------------------------------------------------------------
# the differentiable path (d sum(Li) / d scene parameters, path replay)
# ---------------------------------------------------------------------------

def grad_pass(scene, settings, cfg, labels, sample, counts=None):
    """d sum(Li)/d params of one sample per pixel (bench.py's fwd+bwd
    loss) -> (grads, Li (N, 3)); ``counts()`` read after the forward goes
    into the returned ``fwd_launches``."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in get_params(scene, labels).items()}
    pix = torch.arange(settings.width * settings.height, device=scene.device)
    li = render_rays(set_params(scene, params), settings, cfg, pix, sample,
                     0)
    fwd = counts() if counts else None
    li.sum().backward()
    return {k: p.grad for k, p in params.items()}, li.detach(), fwd


def grad_peak(scene, settings, cfg, labels, counts=None):
    """One fwd+bwd pass from a clean peak: (grads, Li, forward launches,
    peak device GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = grad_pass(scene, settings, cfg, labels, 0, counts)
    torch.cuda.synchronize()
    return (*out, torch.cuda.max_memory_allocated() / 2**30)


def grad_pass_time(scene, settings, cfg, labels, k_lo, k_hi, rays, tag):
    """Per fwd+bwd pass ms from differencing two pass counts (bench.py's
    definition: rays are the forward queries)."""
    def run(k):
        return lambda: [grad_pass(scene, settings, cfg, labels, s)
                        for s in range(k)]

    run(1)()  # warm up once; each count is then timed once
    t_lo = cuda_ms(run(k_lo), 1, warm=False)
    t_hi = cuda_ms(run(k_hi), 1, warm=False)
    per_pass = (t_hi - t_lo) / (k_hi - k_lo)
    log(f"[{tag}] fwd+bwd pass time {per_pass:.3f} ms ({k_lo} passes "
        f"{t_lo:.3f} ms, {k_hi} passes {t_hi:.3f} ms); {rays} rays per pass;"
        f" {rays / (per_pass * 1e-3):.4e} rays/s")
    return per_pass


def check_linearity(tag, grads, li, radiance):
    """The only emitter's radiance scales Li: d sum(Li)/d radiance[c] must
    equal sum(Li_c) / radiance[c] (Li_c summed in float64)."""
    g = grads["emitter.radiance"][0].double().cpu()
    want = li.double().sum(0).cpu() / radiance[0].double().cpu()
    rel = ((g - want).abs() / want.abs()).max().item()
    log(f"[{tag}] radiance linearity: d sum(Li)/d radiance "
        f"{g.tolist()}, sum(Li_c)/radiance_c {want.tolist()}, max rel "
        f"{rel:.3e}")
    if not rel < 1e-3:
        raise AssertionError(f"{tag}: radiance gradient not linear ({rel})")


def check_finite(tag, grads):
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag}: non-finite gradient of {k}")


def grad_rel(a, b):
    return max((a[k] - b[k]).abs().max().item()
               / max(b[k].abs().max().item(), 1e-30) for k in b)


def cornell_grad_phase(dev, fwd_ms):
    """9. bench.py's fwd+bwd configuration on the card."""
    scene, settings = tiny_cornell(dev)
    settings.width = settings.height = RES
    n_iters = DEPTH - 1
    cfg = PathConfig(max_depth=DEPTH, remat=True, remat_group=4)

    def counts():
        return (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)

    ci.reset_launch_counts()
    ch.reset_launch_counts()
    grads, li, fwd, peak4 = grad_peak(scene, settings, cfg, G_LABELS, counts)
    launches = counts()
    log(f"[grad] Cornell {RES}x{RES} depth {DEPTH} remat_group 4: "
        f"launches forward {fwd}, forward+backward {launches}; peak device "
        f"memory {peak4:.3f} GiB")
    want = ((DEPTH, n_iters), (DEPTH + n_iters, 2 * n_iters))
    if (fwd, launches) != want:
        raise AssertionError(f"expected forward {want[0]} and fwd+bwd "
                             f"{want[1]} launches, got {fwd}, {launches}")
    if ch.hier_closest.launches or ch.hier_anyhit.launches:
        raise AssertionError("the Cornell box launched hierarchy kernels")
    check_finite("grad", grads)
    refl = grads["bsdf.refl"]
    log(f"[grad] d sum(Li)/d refl rows 0-2 {refl[:3].tolist()}")
    if not bool((refl[:3] > 0).all()):
        raise AssertionError("refl gradient not positive on the walls")
    check_linearity("grad", grads, li, scene.emitters.radiance)

    peaks, rels = {}, {}
    for name, kw in (("per-bounce remat", dict(remat=True)),
                     ("remat=False", dict(remat=False))):
        g, _, _, peaks[name] = grad_peak(scene, settings, PathConfig(
            max_depth=DEPTH, **kw), G_LABELS)
        rels[name] = grad_rel(g, grads)
        del g
    log(f"[grad] peak device memory: remat_group 4 {peak4:.3f} GiB, "
        + ", ".join(f"{k} {v:.3f} GiB" for k, v in peaks.items())
        + "; max rel difference of the gradients to remat_group 4: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()))
    if not all(r < 1e-5 for r in rels.values()):
        raise AssertionError(f"the remat modes disagree: {rels}")
    rays = RES * RES * (1 + 2 * n_iters)
    per_pass = grad_pass_time(scene, settings, cfg, G_LABELS, 1, 3, rays,
                              "grad")
    log(f"[grad] fwd+bwd pass / forward pass (phase 4) "
        f"{per_pass:.3f} / {fwd_ms:.3f} ms = {per_pass / fwd_ms:.3f}")
    return launches


def grad_parity_phase(dev):
    """10. parity_check._grad_cornell's configuration, card vs CPU."""
    cfg = PathConfig(max_depth=DEPTH, remat=True)
    g = {}
    for where in (dev, "cpu"):
        scene, settings = tiny_cornell(where)
        settings.width = settings.height = 128
        g[str(where)] = grad_pass(scene, settings, cfg, ("bsdf.refl",),
                                  7)[0]["bsdf.refl"].cpu()
    card, cpu = g[str(dev)], g["cpu"]
    rel = ((card - cpu).abs().max() / cpu.abs().max()).item()
    log(f"[grad parity] Cornell 128^2 d sum(Li)/d refl: card "
        f"{card.sum().item():.6e} cpu {cpu.sum().item():.6e} max rel "
        f"{rel:.3e} {'OK' if rel < 5e-3 else 'FAIL'}")
    if not rel < 5e-3:
        raise AssertionError("card vs CPU gradient parity failed")


def large_grad_phase(scene, settings):
    """11. The large scene's gradient: bsdf.alpha moves ray directions."""
    labels = ("bsdf.alpha", "emitter.radiance")
    cfg = PathConfig(max_depth=L_DEPTH, remat=True)
    n_iters = L_DEPTH - 1

    def counts():
        return (ch.hier_closest.launches, ch.hier_anyhit.launches)

    ci.reset_launch_counts()
    ch.reset_launch_counts()
    grads, li, fwd, peak = grad_peak(scene, settings, cfg, labels, counts)
    launches = counts()
    brute = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)
    log(f"[large grad] {L_RES}x{L_RES} depth {L_DEPTH} per-bounce remat: "
        f"hier launches forward {fwd}, forward+backward {launches}, "
        f"brute-force {brute}; peak device memory {peak:.3f} GiB")
    want = ((L_DEPTH, n_iters), (L_DEPTH + n_iters, 2 * n_iters))
    if (fwd, launches) != want or any(brute):
        raise AssertionError(f"expected forward {want[0]} and fwd+bwd "
                             f"{want[1]} hierarchy launches and no "
                             f"brute-force launch, got {fwd}, {launches}, "
                             f"{brute}")
    check_finite("large grad", grads)
    alpha = grads["bsdf.alpha"][0]
    log(f"[large grad] d sum(Li)/d alpha of the mesh {alpha.tolist()}")
    if not bool((alpha != 0).all()):
        raise AssertionError("no alpha gradient on the mesh's BSDF")
    check_linearity("large grad", grads, li, scene.emitters.radiance)
    grad_pass_time(scene, settings, cfg, labels, 1, 3,
                   L_RES * L_RES * (1 + 2 * n_iters), "large grad")
    return launches


# ---------------------------------------------------------------------------
# the new BSDF families and the environment map
# ---------------------------------------------------------------------------

def device_profile(tag, run, passes=1, top=0):
    """Device operations, device ms and idle share per pass of ``run(k)``
    (k passes) under torch.profiler, after one warm-up pass; with ``top``,
    the device ms a pass of the ``top`` kernels by name that take most."""
    run(1)
    events = device_events(run, passes)
    dev = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not dev:
        log(f"[{tag}] device profile: not measured (no device events)")
        return None
    span = max(b for _, b in dev) - dev[0][0]
    out = dict(ops=len(dev) / passes,
               device_ms=sum(b - a for a, b in dev) / 1e3 / passes,
               idle=1.0 - busy_union(dev) / span)
    log(f"[{tag}] device operations per pass {out['ops']:.1f}, device time "
        f"{out['device_ms']:.3f} ms per pass, idle share {out['idle']:.3f} "
        f"(torch.profiler, {passes} passes)")
    if top:
        by_name = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / passes
        out["top"] = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        log(f"[{tag}] largest device ms a pass by kernel: " + "; ".join(
            f"{name[:90]} {ms:.3f}" for name, ms in out["top"]))
    return out


def material_path_phase(dev):
    """12. material_cornell through render_film at bench.py's forward
    configuration."""
    t0 = time.perf_counter()
    scene, settings = material_cornell(dev)
    log(f"[materials] scene built on the host in "
        f"{time.perf_counter() - t0:.2f} s: {scene.geom.n_tris} triangles, "
        f"BSDF types {scene.bsdfs.used_types}, emitters "
        f"{scene.emitters.used_types}, map "
        f"{tuple(scene.emitters.env_rows.shape)}")
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    film = render_film(scene, settings)
    torch.cuda.synchronize()
    launches = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)
    hier = (ch.hier_closest.launches, ch.hier_anyhit.launches)
    spp, depth = settings.spp, settings.integrator_props["max_depth"]
    log(f"[materials] render_film {settings.width}x{settings.height} depth "
        f"{depth} spp {spp}: closest launches {launches[0]}, anyhit "
        f"launches {launches[1]}, hierarchy launches {hier}")
    if launches != (depth * spp, (depth - 1) * spp) or any(hier):
        raise AssertionError(f"expected {depth} closest and {depth - 1} "
                             f"any-hit launches per pass, no hierarchy "
                             f"launch, got {launches}, {hier}")
    img = develop(film).cpu().numpy()
    lum = luminance(img)
    q = settings.width // 8
    log(f"[materials] image mean luminance {lum.mean():.5f}, centre "
        f"{lum[3 * q:5 * q, 3 * q:5 * q].mean():.5f}, top corners "
        f"{lum[:q // 4, :q // 4].mean():.5f} {lum[:q // 4, -q // 4:].mean():.5f}")
    if not np.isfinite(img).all() or (img < 0).any():
        raise AssertionError("image has non-finite or negative pixels")
    if not 0.05 < lum.mean() < 50.0:
        raise AssertionError(f"implausible mean luminance {lum.mean()}")
    rays = settings.width * settings.height * (1 + 2 * (depth - 1))
    per_pass = pass_time(scene, settings, 2, 6, rays)
    prof = device_profile("materials",
                          lambda k: render_film(scene, settings, spp=k))
    return launches, per_pass, prof


def material_parity_phase(dev):
    """13. material_cornell, card vs CPU at 128^2, depth 5."""
    parity_gate(f"material_cornell 128^2 depth {DEPTH}",
                path_luminance(material_cornell(dev)[0], 128, DEPTH),
                path_luminance(material_cornell("cpu")[0], 128, DEPTH))


def sky_path_phase(dev):
    """14. The large scene under the Hosek sky."""
    t0 = time.perf_counter()
    scene, settings = large_scene(dev, env="sky")
    log(f"[sky] scene built on the host in {time.perf_counter() - t0:.2f} "
        f"s: {scene.geom.n_tris} triangles, map "
        f"{tuple(scene.emitters.env_rows.shape)}")
    settings.spp = L_SPP
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    film = render_film(scene, settings)
    torch.cuda.synchronize()
    launches = (ch.hier_closest.launches, ch.hier_anyhit.launches)
    brute = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[sky] render_film {L_RES}x{L_RES} depth {L_DEPTH} spp {L_SPP}: "
        f"hier_closest launches {launches[0]}, hier_anyhit launches "
        f"{launches[1]}, brute-force launches {brute}; peak device memory "
        f"{peak:.3f} GiB")
    if launches != (L_DEPTH * L_SPP, (L_DEPTH - 1) * L_SPP) or any(brute):
        raise AssertionError(f"expected {L_DEPTH} hier_closest, "
                             f"{L_DEPTH - 1} hier_anyhit and no brute-force "
                             f"launches per pass, got {launches}, {brute}")
    img = develop(film).cpu().numpy()
    lum = luminance(img)
    q = L_RES // 8
    centre = lum[3 * q:5 * q, 3 * q:5 * q].mean()
    corners = [lum[:q, :q].mean(), lum[:q, -q:].mean(), lum[-q:, :q].mean(),
               lum[-q:, -q:].mean()]
    log(f"[sky] image mean luminance {lum.mean():.5f}, centre "
        f"{centre:.5f}, corners " + " ".join(f"{c:.5f}" for c in corners))
    if not np.isfinite(img).all() or (img < 0).any():
        raise AssertionError("image has non-finite or negative pixels")
    # the top corners see the sky above the horizon, the bottom ones its
    # faded extension below it
    if min(abs(c - 1.0) for c in corners) < 1e-3 or np.ptp(corners) < 1e-3:
        raise AssertionError("the corners do not see the sky")
    if min(corners[:2]) <= 0.0:
        raise AssertionError("a top corner sees no sky")
    per_pass = pass_time(scene, settings, 1, 3,
                         L_RES * L_RES * (1 + 2 * (L_DEPTH - 1)))
    prof = device_profile("sky", lambda k: render_film(scene, settings,
                                                       spp=k))
    return scene, launches, per_pass, peak, prof


def sky_parity_phase(cuda_scene):
    """15. The sky scene, card vs CPU at 64^2, depth 3."""
    cpu_scene, _ = large_scene("cpu", env="sky")
    parity_gate(f"large scene under the sky ({cpu_scene.geom.n_tris} tris) "
                f"64^2 depth {L_DEPTH}",
                path_luminance(cuda_scene, 64, L_DEPTH),
                path_luminance(cpu_scene, 64, L_DEPTH))


def material_grad_phase(dev):
    """16. The material_cornell gradient at 128^2, depth 5."""
    cfg = PathConfig(max_depth=DEPTH, remat=True, remat_group=4)
    runs = []
    for where in (dev, torch.device("cpu")):
        scene, settings = material_cornell(where)
        settings.width = settings.height = M_GRAD_RES
        ci.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        grads, li, _ = grad_pass(scene, settings, cfg, M_LABELS, 0)
        runs.append(({k: g.cpu() for k, g in grads.items()}, li.cpu(),
                     scene.emitters.radiance.cpu(), scene, settings))
        if not runs[1:]:
            log(f"[materials grad] {M_GRAD_RES}x{M_GRAD_RES} depth {DEPTH} "
                f"remat_group 4: launches (closest, anyhit) fwd+bwd "
                f"{(ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)}, "
                f"peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    (gc, lic, rad, card_scene, card_settings), (gh, *_) = runs
    check_finite("materials grad", gc)
    # both emitters scale Li linearly: sum_e rad_e g_e = sum(Li_c)
    g = gc["emitter.radiance"].double()
    lhs = (g * rad.double()).sum(0)
    want = lic.double().sum(0)
    lin = ((lhs - want).abs() / want.abs()).max().item()
    rels = {k: ((gc[k] - gh[k]).abs().max() / gh[k].abs().max()).item()
            for k in M_LABELS}
    log(f"[materials grad] radiance linearity over both emitters: "
        f"sum_e rad_e d sum(Li)/d rad_e {lhs.tolist()}, sum(Li) "
        f"{want.tolist()}, max rel {lin:.3e}; card vs CPU max rel "
        + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()))
    if not lin < 1e-3:
        raise AssertionError(f"radiance gradient not linear ({lin})")
    if not all(v < 5e-3 for v in rels.values()):
        raise AssertionError(f"card vs CPU gradient parity failed: {rels}")
    if not all(gh[k].abs().max() > 0 for k in M_LABELS):
        raise AssertionError("a gradient of material_cornell is zero")
    return grad_pass_time(card_scene, card_settings, cfg, M_LABELS, 1, 3,
                          M_GRAD_RES * M_GRAD_RES * (1 + 2 * (DEPTH - 1)),
                          "materials grad")


# ---------------------------------------------------------------------------
# textures: bitmaps with MIP pyramids, ray differentials, MASK/BLEND, bump
# and normal maps, and the atlas gradient
# ---------------------------------------------------------------------------

def describe_textures(tag, scene, seconds):
    tex = scene.textures
    mib = tex.atlas.numel() * tex.atlas.element_size() / 2**20
    log(f"[{tag}] scene built on the host in {seconds:.2f} s: "
        f"{scene.geom.n_tris} triangles, {tex.type.shape[0]} textures "
        f"(types {tex.used_types}, MIP {tex.has_mip}), atlas "
        f"{tex.atlas.shape[0]} texels = {mib:.3f} MiB; BSDF types "
        f"{scene.bsdfs.used_types}, textured columns "
        f"{scene.bsdfs.tex_columns}, bump kinds {scene.bsdfs.bump_kinds}")
    return mib


def textured_path_phase(dev):
    """17. textured_cornell through render_film (ray differentials on) at
    bench.py's forward configuration."""
    t0 = time.perf_counter()
    scene, settings = textured_cornell(dev)
    mib = describe_textures("textures", scene, time.perf_counter() - t0)
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    film = render_film(scene, settings)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)
    hier = (ch.hier_closest.launches, ch.hier_anyhit.launches)
    spp, depth = settings.spp, settings.integrator_props["max_depth"]
    log(f"[textures] render_film {settings.width}x{settings.height} depth "
        f"{depth} spp {spp}: closest launches {launches[0]}, anyhit "
        f"launches {launches[1]}, hierarchy launches {hier}; peak device "
        f"memory {peak:.3f} GiB")
    if launches != (depth * spp, (depth - 1) * spp) or any(hier):
        raise AssertionError(f"expected {depth} closest and {depth - 1} "
                             f"any-hit launches per pass, no hierarchy "
                             f"launch, got {launches}, {hier}")
    img = develop(film).cpu().numpy()
    lum = luminance(img)
    q = settings.width // 8
    log(f"[textures] image mean luminance {lum.mean():.5f}, back wall "
        f"{lum[2 * q:4 * q, 3 * q:5 * q].mean():.5f}, floor "
        f"{lum[7 * q:, 3 * q:5 * q].mean():.5f}")
    if not np.isfinite(img).all() or (img < 0).any():
        raise AssertionError("image has non-finite or negative pixels")
    if not 0.05 < lum.mean() < 2.0:
        raise AssertionError(f"implausible mean luminance {lum.mean()}")
    rays = settings.width * settings.height * (1 + 2 * (depth - 1))
    per_pass = pass_time(scene, settings, 2, 6, rays)
    prof = device_profile("textures",
                          lambda k: render_film(scene, settings, spp=k))
    return launches, per_pass, peak, prof, mib


def textured_parity_phase(dev):
    """18. textured_cornell, card vs CPU at 128^2, depth 5, filtered."""
    parity_gate(f"textured_cornell 128^2 depth {DEPTH} (ray differentials)",
                path_luminance(textured_cornell(dev)[0], 128, DEPTH,
                               diffs=True),
                path_luminance(textured_cornell("cpu")[0], 128, DEPTH,
                               diffs=True))


def textured_white_parity_phase(dev):
    """18b. textured_cornell with white-noise bitmap and bump maps
    (full-frequency texels), card vs CPU at 128^2, depth 2, filtered,
    gated from the same camera rays (the CPU's, copied to the card): the
    card's hits, filtered lookups, bump frames and render against the
    CPU's.  From each device's own rays the card's camera directions
    differ from the CPU's in the last bits (its rsqrt), and the floor's
    height map, whose finite difference spans about a texel, turns that
    into a different shading normal (ROADMAP C9): logged, not gated."""
    g = textured_cornell(dev, white_noise=True)[0]
    c = textured_cornell("cpu", white_noise=True)[0]
    cfg = PathConfig(max_depth=2, remat=False)
    s_c, o_c, d_c, dd_c = camera_rays(c, 128, sample=7, diffs=True)
    s_g, o_g, d_g, dd_g = camera_rays(g, 128, sample=7, diffs=True)

    def lum(scene, s, o, d, dd):
        li, _ = path_li_v(scene, s, o, d, cfg, dddx=dd[0], dddy=dd[1])
        return (li.x + li.y + li.z).cpu().numpy()

    def frame(scene, o, d):
        h = scene.ray_intersect_v(o, d)
        it = scene.interaction_v(o, d, h)
        live = h.valid.cpu()
        return h, [t.cpu()[live] for t in (*it.ns, it.uv_u, it.uv_v)]

    def on_card(x):
        return V3(*(t.to(dev) for t in x))

    ref = lum(c, s_c, o_c, d_c, dd_c)
    h_c, f_c = frame(c, o_c, d_c)
    h_o, f_o = frame(g, o_g, d_g)
    st = parity_stats(lum(g, s_g, o_g, d_g, dd_g), ref)
    floor = h_c.shape == 0
    d_err = max_abs_err([t.cpu() for t in d_g], d_c)
    log(f"[textures white] from each device's own camera rays (not gated): "
        f"directions differ by {d_err:.3e}, hit u "
        f"by {max_abs_err([h_o.u.cpu()], [h_c.u]):.3e}, shading normals by "
        f"{max_abs_err(f_o[:3], f_c[:3]):.3e}; render rel {st['rel']:.2e} "
        f"p999 {st['p999']:.2e} frac_bad {st['frac_bad']:.2e} (on the "
        f"height-mapped floor {st['bad'][floor.numpy()].mean():.2e}, "
        f"elsewhere {st['bad'][~floor.numpy()].mean():.2e})")
    o, d, dd = on_card(o_c), on_card(d_c), [on_card(x) for x in dd_c]
    h_g, f_g = frame(g, o, d)
    hit_mism = mismatches([getattr(h_g, k).cpu() for k in ("t", "u", "v",
                                                          "prim")],
                          [getattr(h_c, k) for k in ("t", "u", "v",
                                                     "prim")])
    err = max_abs_err(f_g, f_c)
    log(f"[textures white] from the CPU's camera rays: hit mismatches "
        f"{hit_mism}, shading normals and uvs differ by {err:.3e}")
    if hit_mism or not err < 1e-5:
        raise AssertionError("white-noise textured hits or frames differ")
    parity_gate("textured_cornell, white noise, 128^2 depth 2 (ray "
                "differentials, the CPU's camera rays)",
                lum(g, s_g, o, d, dd), ref)


def textured_large_phase(dev):
    """19. The large scene with a bitmap on its mesh (spherical uvs)."""
    t0 = time.perf_counter()
    scene, settings = large_scene(dev, texture=True)
    describe_textures("textured large", scene, time.perf_counter() - t0)
    settings.spp = L_SPP
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    film = render_film(scene, settings)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = (ch.hier_closest.launches, ch.hier_anyhit.launches)
    brute = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)
    log(f"[textured large] render_film {L_RES}x{L_RES} depth {L_DEPTH} spp "
        f"{L_SPP}: hier_closest launches {launches[0]}, hier_anyhit "
        f"launches {launches[1]}, brute-force launches {brute}; peak "
        f"device memory {peak:.3f} GiB")
    if launches != (L_DEPTH * L_SPP, (L_DEPTH - 1) * L_SPP) or any(brute):
        raise AssertionError(f"expected {L_DEPTH} hier_closest, "
                             f"{L_DEPTH - 1} hier_anyhit and no brute-force "
                             f"launches per pass, got {launches}, {brute}")
    img = develop(film).cpu().numpy()
    lum = luminance(img)
    q = L_RES // 8
    centre = lum[3 * q:5 * q, 3 * q:5 * q]
    log(f"[textured large] image mean luminance {lum.mean():.5f}, centre "
        f"{centre.mean():.5f} (std {centre.std():.5f})")
    if not np.isfinite(img).all() or (img < 0).any():
        raise AssertionError("image has non-finite or negative pixels")
    if not 0.2 < lum.mean() < 1.5:
        raise AssertionError(f"implausible mean luminance {lum.mean()}")
    per_pass = pass_time(scene, settings, 1, 3,
                         L_RES * L_RES * (1 + 2 * (L_DEPTH - 1)))
    parity_gate(f"textured large scene 64^2 depth {L_DEPTH} (ray "
                f"differentials)",
                path_luminance(scene, 64, L_DEPTH, diffs=True),
                path_luminance(large_scene("cpu", texture=True)[0], 64,
                               L_DEPTH, diffs=True))
    return launches, per_pass, peak


def scatter_share(tag, run):
    """Device ms of one fwd+bwd pass of ``run()`` and the share of it in
    the gathers' backward scatter (torch.profiler; the caller has warmed
    ``run`` up)."""
    ev = device_events(lambda _: run(), 1)
    if not ev:
        log(f"[{tag}] scatter share: not measured (no device events)")
        return None
    total, scat = device_us(ev) / 1e3, device_us(ev, SCATTER) / 1e3
    log(f"[{tag}] device time of one fwd+bwd pass {total:.3f} ms, "
        f"{len(ev)} device operations; in index_put/indexing_backward "
        f"{scat:.3f} ms = {scat / total:.3f} (torch.profiler)")
    return scat / total


def texture_grad_phase(dev, fwd_ms):
    """20. d sum(Li)/d texture.atlas on textured_cornell at bench.py's
    fwd+bwd configuration, and card vs CPU at 64^2."""
    scene, settings = textured_cornell(dev)
    n_iters = DEPTH - 1
    cfg = PathConfig(max_depth=DEPTH, remat=True, remat_group=4)

    def counts():
        return (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)

    ci.reset_launch_counts()
    ch.reset_launch_counts()
    grads, li, fwd, peak = grad_peak(scene, settings, cfg, T_LABELS, counts)
    launches = counts()
    log(f"[texture grad] {RES}x{RES} depth {DEPTH} remat_group 4: launches "
        f"forward {fwd}, forward+backward {launches}; peak device memory "
        f"{peak:.3f} GiB")
    want = ((DEPTH, n_iters), (DEPTH + n_iters, 2 * n_iters))
    if (fwd, launches) != want:
        raise AssertionError(f"expected forward {want[0]} and fwd+bwd "
                             f"{want[1]} launches, got {fwd}, {launches}")
    if ch.hier_closest.launches or ch.hier_anyhit.launches:
        raise AssertionError("textured_cornell launched hierarchy kernels")
    check_finite("texture grad", grads)
    g = grads["texture.atlas"]
    tex = scene.textures  # texture 0: the back wall's bitmap
    base = int(tex.width[0]) * int(tex.height[0])  # its base level
    nz = int((g[:base] != 0).any(1).sum())
    log(f"[texture grad] d sum(Li)/d atlas: {nz} of the bitmap's {base} "
        f"base texels non-zero, sum {g[:base].sum().item():.6e}, max "
        f"|g| {g.abs().max().item():.6e}")
    if nz < base // 100:
        raise AssertionError("the bitmap's texels got no gradient")
    check_linearity("texture grad", grads, li, scene.emitters.radiance)
    del grads, li, g
    rays = RES * RES * (1 + 2 * n_iters)
    per_pass = grad_pass_time(scene, settings, cfg, T_LABELS, 1, 2, rays,
                              "texture grad")
    log(f"[texture grad] fwd+bwd pass / forward pass (phase 17) "
        f"{per_pass:.3f} / {fwd_ms:.3f} ms = {per_pass / fwd_ms:.3f}")
    share = scatter_share("texture grad", lambda: grad_pass(
        scene, settings, cfg, T_LABELS, 0))
    del scene

    g = {}
    for where in (dev, "cpu"):
        sc, st = textured_cornell(where)
        st.width = st.height = T_GRAD_PARITY_RES
        g[str(where)] = grad_pass(sc, st, cfg, ("texture.atlas",),
                                  7)[0]["texture.atlas"].cpu()
    card, cpu = g[str(dev)], g["cpu"]
    rel = ((card - cpu).abs().max() / cpu.abs().max()).item()
    log(f"[texture grad parity] {T_GRAD_PARITY_RES}^2 d sum(Li)/d atlas: "
        f"card {card.sum().item():.6e} cpu {cpu.sum().item():.6e} max rel "
        f"{rel:.3e} {'OK' if rel < 5e-3 else 'FAIL'}")
    if not rel < 5e-3:
        raise AssertionError("card vs CPU atlas gradient parity failed")
    return launches, per_pass, peak, share


# ---------------------------------------------------------------------------
# samplers, sensors, filters and lights: lights_cornell and the sun and sky
# ---------------------------------------------------------------------------

def sampler_blocks(where, kind, sample, n):
    """N_BLOCKS blocks of ``kind`` for pixels 0..n-1 on ``where``, as
    (N_BLOCKS * 4) CPU tensors."""
    pix = torch.arange(n, dtype=torch.int64, device=where)
    if isinstance(sample, torch.Tensor):
        sample = sample.to(where)
    s = rng.make_sampler_v(pix, sample, 77, kind=kind, spp=4)
    out = []
    for _ in range(N_BLOCKS):
        s, u = rng.next_block4_v(s)
        out += [t.cpu() for t in u]
    return out


def sampler_phase(dev):
    """21. Every sampler kind on the card against the same call on the
    CPU, bit for bit: 2^20 lanes x N_BLOCKS blocks with the sample index
    every lane shares (a render pass), and 2^16 lanes with one index per
    lane; then device operations and card ms of one block at 2^20 lanes."""
    per_lane = torch.randint(0, 64, (1 << 16,), generator=torch.Generator()
                             .manual_seed(21))
    bad = {}
    for name, kind in KIND_BY_NAME.items():
        for sample, n in ((5, N_RAYS), (per_lane, 1 << 16)):
            card = sampler_blocks(dev, kind, sample, n)
            cpu = sampler_blocks("cpu", kind, sample, n)
            m = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                    for a, b in zip(card, cpu))
            bad[(name, n)] = m
    log("[samplers] card vs CPU, " + f"{N_BLOCKS} blocks: mismatches "
        + ", ".join(f"{k} {n} lanes {m}" for (k, n), m in bad.items()))
    if any(bad.values()):
        raise AssertionError(f"sampler words differ card vs CPU: {bad}")
    pix = torch.arange(N_RAYS, dtype=torch.int64, device=dev)
    ops = {}
    for name in KIND_BY_NAME:
        s = rng.make_sampler_v(pix, 5, 77, kind=KIND_BY_NAME[name], spp=4)
        ev = device_events(lambda k: [rng.next_block4_v(s)
                                      for _ in range(k)], 4)
        ms = cuda_ms(lambda: rng.next_block4_v(s), 20)
        ops[name] = (len(ev) / 4 if ev else None, ms)
    log("[samplers] one block at 2^20 lanes: " + ", ".join(
        f"{k} {fmt(o)} device operations, {ms:.4f} ms"
        for k, (o, ms) in ops.items()))
    return ops


def film_luminance(scene, settings, res, depth, spp=1):
    """Per-pixel Li sum of a render_film at res^2 through the settings'
    sampler and filter (CPU numpy)."""
    st = dataclasses.replace(settings, width=res, height=res,
                             integrator_props=dict(max_depth=depth))
    return develop(render_film(scene, st, spp=spp)).sum(-1).cpu().numpy()


def with_options(settings, sampler=None, rfilter=None):
    kw = {}
    if sampler is not None:
        kw["sampler"] = sampler
    if rfilter is not None:
        kw.update(rfilter=rfilter, rfilter_radius=None)
    return dataclasses.replace(settings, **kw)


def pass_times_in_turns(scene, variants, k_lo, k_hi, rounds=1):
    """{name: [per-pass ms, ...]} of each settings variant, differencing
    k_lo and k_hi passes, the variants in turns (forward, then back,
    ``rounds`` times)."""
    order = (list(variants) + list(reversed(variants))) * rounds
    out = {k: [] for k in variants}
    for k in variants:  # warm up
        render_film(scene, variants[k], spp=1)
    for k in order:
        def run(n, st=variants[k]):
            return lambda: render_film(scene, st, spp=n)
        out[k].append((cuda_ms(run(k_hi), 1) - cuda_ms(run(k_lo), 1))
                      / (k_hi - k_lo))
    return out


def lights_path_phase(dev):
    """22. lights_cornell through render_film at bench.py's forward
    configuration with ldsampler, the Gaussian filter and the thin lens;
    the sampler's and the filter's cost in turns; each light alone."""
    t0 = time.perf_counter()
    scene, settings = lights_cornell(dev)
    em = scene.emitters
    log(f"[lights] scene built on the host in {time.perf_counter() - t0:.2f}"
        f" s: {scene.geom.n_tris} triangles, {scene.geom.n_spheres} sphere, "
        f"{scene.geom.n_disks} disk; emitter types {em.used_types}, area "
        f"kinds {em.used_area_kinds}; sensor type {scene.sensor.type}; "
        f"sampler {settings.sampler}, filter {settings.rfilter} radius "
        f"{settings.rfilter_radius}")
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    film = render_film(scene, settings)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)
    hier = (ch.hier_closest.launches, ch.hier_anyhit.launches)
    spp, depth = settings.spp, settings.integrator_props["max_depth"]
    log(f"[lights] render_film {settings.width}x{settings.height} depth "
        f"{depth} spp {spp}: closest launches {launches[0]}, anyhit "
        f"launches {launches[1]}, hierarchy launches {hier}; peak device "
        f"memory {peak:.3f} GiB")
    if launches != (depth * spp, (depth - 1) * spp) or any(hier):
        raise AssertionError(f"expected {depth} closest and {depth - 1} "
                             f"any-hit launches per pass, no hierarchy "
                             f"launch, got {launches}, {hier}")
    img = develop(film).cpu().numpy()
    lum = luminance(img)
    log(f"[lights] image mean luminance {lum.mean():.5f}, max "
        f"{lum.max():.5f}")
    if not np.isfinite(img).all() or (img < 0).any():
        raise AssertionError("image has non-finite or negative pixels")
    if not 0.02 < lum.mean() < 50.0:
        raise AssertionError(f"implausible mean luminance {lum.mean()}")
    rays = settings.width * settings.height * (1 + 2 * (depth - 1))
    per_pass = pass_time(scene, settings, 2, 6, rays, "lights")
    prof = device_profile("lights",
                          lambda k: render_film(scene, settings, spp=k))

    # each sampler with the Gaussian, and the box filter's saving
    pairs = [(k, "gaussian") for k in KIND_BY_NAME] + [
        ("ldsampler", "box"), ("independent", "box")]
    variants = {f"{smp}+{flt}": with_options(settings, smp,
                                             FILTER_NAMES[flt])
                for smp, flt in pairs}
    times = pass_times_in_turns(scene, variants, 1, 3)
    costs = {}
    for k, st in variants.items():
        p = device_profile(f"lights {k}",
                           lambda n, st=st: render_film(scene, st, spp=n))
        costs[k] = (times[k], p and p["ops"], p and p["device_ms"])
    log("[lights] pass ms in turns (there and back; median) and "
        "device operations and device ms per pass: " + "; ".join(
            f"{k} {statistics.median(ts):.3f} ms ("
            f"{', '.join(f'{t:.3f}' for t in ts)}), {fmt(o)} ops, "
            f"{fmt(d)} device ms" for k, (ts, o, d) in costs.items()))
    del scene, film

    alone = {}
    for light in LIGHTS:
        sc, st = lights_cornell(dev, lights=(light,))
        img = develop(render_film(sc, dataclasses.replace(
            st, width=128, height=128, spp=1))).cpu().numpy()
        alone[light] = float(luminance(img).mean())
        if not np.isfinite(img).all() or (img < 0).any():
            raise AssertionError(f"{light} alone: non-finite or negative")
        if (alone[light] > 0) != (light != "collimated"):
            raise AssertionError(f"{light} alone: mean luminance "
                                 f"{alone[light]}")
    log("[lights] each light alone at 128^2 (1 spp), mean luminance: "
        + ", ".join(f"{k} {v:.5f}" for k, v in alone.items()))
    return launches, per_pass, peak, prof, costs


def sweep_sensor(scene, stype, where):
    """lights_cornell's camera as a sensor of type ``stype`` (thin-lens and
    telecentric apertures, orthographic half-extents 1.1)."""
    c = CORNELL_CAMERA
    return dataclasses.replace(scene, sensor=make_sensor(
        stype, Transform.look_at(c["origin"], c["target"], c["up"]),
        fov_deg=c["fov_deg"], scale_x=1.1, scale_y=1.1, **LIGHTS_LENS,
        device=where))


def lights_parity_phase(dev):
    """23. lights_cornell card vs CPU at 128^2, depth 5, then one option
    at a time at SWEEP_RES^2, depth SWEEP_DEPTH: each sensor type, sampler
    and filter, all under parity_check.py's gate."""
    card, settings = lights_cornell(dev)
    cpu, _ = lights_cornell("cpu")
    parity_gate(f"lights_cornell 128^2 depth {DEPTH} (thin lens, "
                f"ldsampler, gaussian)",
                film_luminance(card, settings, 128, DEPTH),
                film_luminance(cpu, settings, 128, DEPTH))
    cases = [(f"sensor {t}", sweep_sensor(card, t, dev),
              sweep_sensor(cpu, t, "cpu"), settings) for t in range(7)]
    cases += [(f"sampler {k}", card, cpu, with_options(settings, sampler=k))
              for k in KIND_BY_NAME]
    cases += [(f"filter {k}", card, cpu, with_options(settings, rfilter=f))
              for k, f in FILTER_NAMES.items()]
    for name, g, c, st in cases:
        # the samplers at the scene's spp, so that the strata differ
        spp = st.spp if name.startswith("sampler") else 1
        parity_gate(f"lights_cornell {SWEEP_RES}^2 depth {SWEEP_DEPTH} spp "
                    f"{spp}, {name}",
                    film_luminance(g, st, SWEEP_RES, SWEEP_DEPTH, spp),
                    film_luminance(c, st, SWEEP_RES, SWEEP_DEPTH, spp))
    return len(cases)


def sunsky_path_phase(dev):
    """24. The large scene under the Preetham sky and the sun (sobol,
    Mitchell, 2 spp); its top rows against the sky's radiance; card vs CPU
    at 64^2."""
    t0 = time.perf_counter()
    scene, settings = large_scene(dev, env="sunsky")
    em = scene.emitters
    sun = em.type.cpu().tolist().index(EM_DIRECTIONAL)
    log(f"[sunsky] scene built on the host in {time.perf_counter() - t0:.2f}"
        f" s: {scene.geom.n_tris} triangles, emitter types {em.used_types}, "
        f"map {tuple(em.env_rows.shape)}, sun irradiance "
        f"{em.intensity[sun].tolist()} along {em.direction[sun].tolist()}; "
        f"sampler {settings.sampler}, filter {settings.rfilter}, spp "
        f"{settings.spp}")
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    film = render_film(scene, settings)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = (ch.hier_closest.launches, ch.hier_anyhit.launches)
    brute = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)
    spp = settings.spp
    log(f"[sunsky] render_film {L_RES}x{L_RES} depth {L_DEPTH} spp {spp}: "
        f"hier_closest launches {launches[0]}, hier_anyhit launches "
        f"{launches[1]}, brute-force launches {brute}; peak device memory "
        f"{peak:.3f} GiB")
    if launches != (L_DEPTH * spp, (L_DEPTH - 1) * spp) or any(brute):
        raise AssertionError(f"expected {L_DEPTH} hier_closest, "
                             f"{L_DEPTH - 1} hier_anyhit and no brute-force "
                             f"launches per pass, got {launches}, {brute}")
    img = develop(film).cpu().numpy()
    if not np.isfinite(img).all():
        raise AssertionError("image has non-finite pixels")
    # the top rows see the sky above the horizon, far from the mesh: a
    # pixel's value is the map's radiance toward its centre, to the
    # filter's averaging over +-2 pixels (the bottom rows look below the
    # horizon, where the map is 0, and would hold nothing)
    r = L_RES
    band = [(y, int(x)) for y in (0, r // 16)
            for x in np.linspace(0, r - 1, 9).round()]
    uu = torch.tensor([(x + 0.5) / r for _, x in band], device=dev)
    vv = torch.tensor([(y + 0.5) / r for y, _ in band], device=dev)
    z = torch.zeros_like(uu)
    _, d, _ = sample_ray_v(scene.sensor, uu, vv, z, z)
    sky = luminance(torch.stack(list(eval_environment_v(em, d)),
                                -1).cpu().numpy())
    got = np.array([luminance(img[y, x]) for y, x in band])
    log(f"[sunsky] luminance of {len(band)} pixels in rows 0 and {r // 16}: "
        f"{got.tolist()}, the sky's toward them {sky.tolist()}")
    if not (sky > 0.0).all():
        raise AssertionError("a checked pixel looks where the sky is 0")
    if not (np.abs(got - sky) <= 0.05 * sky).all():
        raise AssertionError("the top rows are not the sky's radiance")
    per_pass = pass_time(scene, settings, 1, 3,
                         L_RES * L_RES * (1 + 2 * (L_DEPTH - 1)), "sunsky")
    prof = device_profile("sunsky", lambda k: render_film(scene, settings,
                                                          spp=k))
    parity_gate(f"large scene under sunsky 64^2 depth {L_DEPTH} (sobol, "
                f"mitchell)",
                film_luminance(scene, settings, 64, L_DEPTH),
                film_luminance(large_scene("cpu", env="sunsky")[0],
                               settings, 64, L_DEPTH))
    return launches, per_pass, peak, prof


def lights_grad_phase(dev):
    """25. d sum(Li)/d bsdf.refl and emitter.radiance on lights_cornell at
    128^2, depth 5, remat_group 4: launches forward and with the replay,
    finite, card vs CPU."""
    cfg = PathConfig(max_depth=DEPTH, remat=True, remat_group=4)

    def counts():
        return (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)

    g = {}
    for where in (dev, "cpu"):
        scene, settings = lights_cornell(where)
        settings.width = settings.height = M_GRAD_RES
        ci.reset_launch_counts()
        grads, _, fwd = grad_pass(scene, settings, cfg, G_LABELS, 0, counts)
        g[str(where)] = {k: v.cpu() for k, v in grads.items()}
        if where == dev:
            launches = (fwd, counts())
    log(f"[lights grad] {M_GRAD_RES}^2 depth {DEPTH} remat_group 4: "
        f"launches forward {launches[0]}, forward+backward {launches[1]}")
    want = ((DEPTH, DEPTH - 1), (2 * DEPTH - 1, 2 * (DEPTH - 1)))
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    card, cpu = g[str(dev)], g["cpu"]
    check_finite("lights grad", card)
    rels = {k: ((card[k] - cpu[k]).abs().max() / cpu[k].abs().max()).item()
            for k in G_LABELS}
    log(f"[lights grad] card vs CPU max rel " + ", ".join(
        f"{k} {v:.3e}" for k, v in rels.items()) + "; d sum(Li)/d radiance "
        f"rows {card['emitter.radiance'].sum(1).tolist()}")
    if not all(v < 5e-3 for v in rels.values()):
        raise AssertionError(f"card vs CPU gradient parity failed: {rels}")
    if not all(cpu[k].abs().max() > 0 for k in G_LABELS):
        raise AssertionError("a gradient of lights_cornell is zero")
    return launches, rels


# ---------------------------------------------------------------------------
# a user's scene from disk: the scene loader and the command line
# ---------------------------------------------------------------------------

XML_DIR = os.path.join("build", "chip_smoke_xml")  # gitignored (build/)

# tests/test_render.py's Cornell box (copied: the smoke imports no test)
CORNELL_XML = """\
<scene version="0.6.0">
    <integrator type="path">
        <integer name="maxDepth" value="{max_depth}"/>
    </integrator>
    <sensor type="perspective">
        <float name="fov" value="39.3"/>
        <transform name="toWorld">
            <lookat origin="0, 1, 3.9" target="0, 1, 0" up="0, 1, 0"/>
        </transform>
        <sampler type="independent">
            <integer name="sampleCount" value="{spp}"/>
        </sampler>
        <film type="hdrfilm">
            <integer name="width" value="{res}"/>
            <integer name="height" value="{res}"/>
            <rfilter type="box"/>
        </film>
    </sensor>
    <bsdf type="diffuse" id="white"><rgb name="reflectance" value="0.725 0.71 0.68"/></bsdf>
    <bsdf type="diffuse" id="red"><rgb name="reflectance" value="0.63 0.065 0.05"/></bsdf>
    <bsdf type="diffuse" id="green"><rgb name="reflectance" value="0.14 0.45 0.091"/></bsdf>

    <!-- floor -->
    <shape type="rectangle">
        <transform name="toWorld"><rotate x="1" angle="-90"/><scale value="1"/></transform>
        <ref id="white"/>
    </shape>
    <!-- ceiling -->
    <shape type="rectangle">
        <transform name="toWorld"><rotate x="1" angle="90"/><translate y="2"/></transform>
        <ref id="white"/>
    </shape>
    <!-- back wall -->
    <shape type="rectangle">
        <transform name="toWorld"><translate z="-1"/><translate y="1"/></transform>
        <ref id="white"/>
    </shape>
    <!-- left wall (red) -->
    <shape type="rectangle">
        <transform name="toWorld"><rotate y="1" angle="90"/><translate x="-1" y="1"/></transform>
        <ref id="red"/>
    </shape>
    <!-- right wall (green) -->
    <shape type="rectangle">
        <transform name="toWorld"><rotate y="1" angle="-90"/><translate x="1" y="1"/></transform>
        <ref id="green"/>
    </shape>
    <!-- light -->
    <shape type="rectangle">
        <transform name="toWorld"><rotate x="1" angle="90"/><scale value="0.25"/><translate y="1.99"/></transform>
        <ref id="white"/>
        <emitter type="area"><rgb name="radiance" value="17 12 4"/></emitter>
    </shape>
</scene>
"""


def xml_file(name, text):
    os.makedirs(XML_DIR, exist_ok=True)
    path = os.path.join(XML_DIR, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def run_cli(*args):
    """The port's command line, in this process, as a user calls it."""
    if cli_main.main([str(a) for a in args] + ["-q"]) != 0:
        raise AssertionError(f"the command line failed: {args}")


class Spy:
    """Wraps ``module.name`` while active: the seconds of its calls and
    its last result."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.seconds, self.result = 0.0, None

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            self.result = self.orig(*a, **kw)
            self.seconds += time.perf_counter() - t0
            return self.result

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def film_of(ckpt):
    return np.load(ckpt + ".npz")["film"]


def film_diff(a, b):
    """'bit for bit', or how many film entries differ and by how much."""
    d = np.abs(a - b)
    if not d.any():
        return "bit for bit"
    return f"DIFFERENT in {int((d > 0).sum())} entries, max {d.max():.3e}"


def left_right(img):
    n = img.shape[1]
    rows = slice(int(0.3 * img.shape[0]), int(0.7 * img.shape[0]))
    lo, hi = int(0.05 * n), int(0.15 * n)
    return img[rows, lo:hi].mean((0, 1)), img[rows, n - hi:n - lo].mean((0, 1))


def xml_cornell_phase(dev, smi):
    path = xml_file("cornell.xml", CORNELL_XML.format(max_depth=DEPTH,
                                                      spp=SPP, res=RES))
    t0 = time.perf_counter()
    scene, settings = scene_xml.load_scene(path, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"[xml cornell] {path}: load and build {load_s:.4f} s, "
        f"{scene.geom.n_tris} triangles ({smi})")
    out, ckpt = os.path.join(XML_DIR, "cornell"), os.path.join(XML_DIR, "ck")
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    run_cli(path, "-o", out + ".exr", "-c", ckpt + "_full")
    torch.cuda.synchronize()
    launches = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)
    hier = (ch.hier_closest.launches, ch.hier_anyhit.launches)
    log(f"[xml cornell] command line {RES}x{RES} depth {DEPTH} spp {SPP}: "
        f"closest launches {launches[0]}, anyhit launches {launches[1]}, "
        f"hierarchy launches {hier}")
    if launches != (DEPTH * SPP, (DEPTH - 1) * SPP) or any(hier):
        raise AssertionError(f"expected {DEPTH} + {DEPTH - 1} brute-force "
                             f"launches per pass, got {launches}, {hier}")
    img, meta = exr.read_exr(out + ".exr")
    left, right = left_right(img)
    lum = luminance(img)
    log(f"[xml cornell] EXR {img.shape} renderTime {meta['renderTime']}, "
        f"mean luminance {lum.mean():.5f}, left rgb "
        f"{np.round(left, 4).tolist()}, right rgb "
        f"{np.round(right, 4).tolist()}")
    if (img.shape != (RES, RES, 3) or not np.isfinite(img).all()
            or (img < 0).any() or not 0.05 < lum.mean() < 2.0):
        raise AssertionError("implausible EXR from the command line")
    if not (left[0] > left[1] and right[1] > right[0]):
        raise AssertionError("red wall not on the left / green not on right")

    direct = render_film(scene, settings).data.cpu().numpy()
    full = film_of(ckpt + "_full")
    same = film_diff(full, direct)
    log(f"[xml cornell] command-line film vs render_film on the loaded "
        f"scene: {same}")
    if same != "bit for bit":
        raise AssertionError("the command line's film is not render_film's")

    run_cli(path, "-s", SPP // 2, "-o", out + ".png", "-c", ckpt + "_half")
    run_cli(path, "-o", out + "_resumed.exr", "-z", ckpt + "_half",
            "-c", ckpt + "_resumed")
    same = film_diff(film_of(ckpt + "_resumed"), full)
    ldr = png.read_png(out + ".png")
    pl, pr = left_right(ldr)
    log(f"[xml cornell] -s {SPP // 2} -c then -z to {SPP} spp: {same}; PNG "
        f"{ldr.shape} left rgb {np.round(pl, 4).tolist()} right rgb "
        f"{np.round(pr, 4).tolist()}")
    if same != "bit for bit":
        raise AssertionError("the resumed film is not the uninterrupted one")
    if ldr.shape != (RES, RES, 3) or not (pl[0] > pl[1] and pr[1] > pr[0]):
        raise AssertionError("implausible PNG from the command line")
    per_pass = pass_time(scene, settings, 2, 6,
                         RES * RES * (1 + 2 * (DEPTH - 1)), "xml cornell")
    cpu_scene, _ = scene_xml.load_scene(path, device="cpu")
    parity_gate("xml cornell 128^2", path_luminance(scene, 128, DEPTH),
                path_luminance(cpu_scene, 128, DEPTH))
    return launches, load_s, per_pass


LARGE_XML = """<scene version="0.6.0">
  <integrator type="path"><integer name="maxDepth" value="{depth}"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="{fov}"/>
    <transform name="toWorld"><lookat origin="{origin}" target="{target}"
      up="{up}"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="{spp}"/>
    </sampler>
    <film type="hdrfilm"><integer name="width" value="{res}"/>
      <integer name="height" value="{res}"/><rfilter type="box"/></film>
  </sensor>
  <emitter type="envmap"><string name="filename" value="sky.exr"/></emitter>
  <shape type="ply"><string name="filename" value="sphere.ply"/>
    <bsdf type="roughconductor"><string name="material" value="Cu"/>
      <float name="alpha" value="0.2"/>
      <string name="distribution" value="ggx"/></bsdf>
  </shape>
</scene>
"""


def write_large_files():
    """The displaced sphere as a binary PLY (float32 positions, normals and
    uvs; uchar-counted int triangles) and the Hosek sky as a float EXR."""
    pos, idx = displaced_sphere(1_120_000)
    nrm = mesh_mod.TriMesh(pos, idx).compute_normals().normals
    n = int(np.sqrt(1_120_000 / 2)) + 1
    k = np.arange(len(pos))
    uv = np.stack([(k % n) / n, (k // n) / (n - 1.0)], 1)
    vert = np.zeros(len(pos), [(c, "<f4") for c in
                               ("x", "y", "z", "nx", "ny", "nz", "u", "v")])
    for j, c in enumerate(("x", "y", "z")):
        vert[c], vert["n" + c] = pos[:, j], nrm[:, j]
    vert["u"], vert["v"] = uv[:, 0], uv[:, 1]
    face = np.zeros(len(idx), [("n", "u1"), ("i", "<i4", 3)])
    face["n"], face["i"] = 3, idx
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0",
         f"element vertex {len(pos)}"]
        + [f"property float {c}" for c in vert.dtype.names]
        + [f"element face {len(idx)}",
           "property list uchar int vertex_indices", "end_header", ""])
    os.makedirs(XML_DIR, exist_ok=True)
    with open(os.path.join(XML_DIR, "sphere.ply"), "wb") as f:
        f.write(header.encode() + vert.tobytes() + face.tobytes())
    exr.write_exr(os.path.join(XML_DIR, "sky.exr"),
                  hosek.hosek_sky_pixels(512, SUN_DIR), half=False)
    return len(idx)


def xml_large_phase(dev, smi):
    t0 = time.perf_counter()
    n_tris = write_large_files()
    c = LARGE_CAMERA
    path = xml_file("large.xml", LARGE_XML.format(
        depth=L_DEPTH, fov=c["fov_deg"], res=L_RES, spp=L_SPP,
        **{k: ", ".join(map(str, c[k])) for k in ("origin", "target",
                                                    "up")}))
    log(f"[xml large] wrote {n_tris} triangles as a binary PLY and the "
        f"Hosek sky as an EXR in {time.perf_counter() - t0:.2f} s")
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out = os.path.join(XML_DIR, "large.exr")
    with Spy(mesh_mod, "load_ply") as ply, Spy(bitmap, "read_exr") as rd, \
            Spy(scene_build, "build_hierarchy") as hb, \
            Spy(scene_xml, "load_scene") as ld:
        run_cli(path, "-o", out)
    torch.cuda.synchronize()
    launches = (ch.hier_closest.launches, ch.hier_anyhit.launches)
    brute = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    scene, settings = ld.result
    log(f"[xml large] load: PLY {ply.seconds:.3f} s, EXR read "
        f"{rd.seconds:.3f} s, hierarchy build {hb.seconds:.3f} s, whole "
        f"load and build {ld.seconds:.3f} s; {scene.geom.n_tris} triangles "
        f"({smi})")
    log(f"[xml large] command line {L_RES}x{L_RES} depth {L_DEPTH} spp "
        f"{L_SPP}: hier_closest launches {launches[0]}, hier_anyhit launches "
        f"{launches[1]}, brute-force launches {brute}; peak device memory "
        f"{peak:.3f} GiB")
    if (launches != (L_DEPTH * L_SPP, (L_DEPTH - 1) * L_SPP) or any(brute)
            or scene.geom.n_tris != n_tris or scene.clusters is None):
        raise AssertionError(f"expected {L_DEPTH} + {L_DEPTH - 1} hierarchy "
                             f"launches per pass and no brute-force launch, "
                             f"got {launches}, {brute}")
    img, _ = exr.read_exr(out)
    lum = luminance(img)
    top = lum[0]
    log(f"[xml large] image mean luminance {lum.mean():.5f}, top row "
        f"min {top.min():.5f} mean {top.mean():.5f}, centre "
        f"{lum[L_RES // 2 - 8:L_RES // 2 + 8].mean():.5f}")
    if not np.isfinite(img).all() or (img < 0).any() or top.min() <= 0:
        raise AssertionError("the top row is not lit by the map")
    per_pass = pass_time(scene, settings, 1, 3,
                         L_RES * L_RES * (1 + 2 * (L_DEPTH - 1)), "xml large")
    cpu_scene, _ = scene_xml.load_scene(path, device="cpu")
    parity_gate(f"xml large ({n_tris} tris) 64^2 depth {L_DEPTH}",
                path_luminance(scene, 64, L_DEPTH),
                path_luminance(cpu_scene, 64, L_DEPTH))
    return launches, dict(ply=ply.seconds, exr=rd.seconds,
                          hierarchy=hb.seconds, load=ld.seconds,
                          pass_ms=per_pass, peak_gib=peak)


PLUGIN_HEAD = """<scene version="0.6.0">
  <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
  <sensor type="perspective"><float name="fov" value="45"/>
    <transform name="toWorld"><lookat origin="0, 1.2, 4" target="0, 0.5, 0"
      up="0, 1, 0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="1"/>
    </sampler>
    {film}
  </sensor>
  <shape type="rectangle"><transform name="toWorld"><rotate x="1"
    angle="-90"/><scale value="3"/></transform></shape>
"""
HDR_FILM = """<film type="hdrfilm"><integer name="width" value="64"/>
      <integer name="height" value="64"/></film>"""
PLUGIN_XML = {
    "meshes": """
  <shape type="obj"><string name="filename" value="grid.obj"/>
    <transform name="toWorld"><scale value="0.5"/><translate x="-1"
      y="0.6"/></transform><bsdf type="plastic"/></shape>
  <shape type="serialized"><string name="filename" value="grid.serialized"/>
    <integer name="shapeIndex" value="1"/>
    <transform name="toWorld"><scale value="0.4"/><translate x="1"
      y="0.5"/></transform></shape>
  <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
    <rotate y="1" angle="30"/><translate y="0.3"/></transform>
    <bsdf type="roughconductor"/></shape>
  <shape type="cylinder"><point name="p0" x="0" y="1" z="-0.5"/>
    <point name="p1" x="0" y="1.5" z="-0.5"/><float name="radius" value="0.2"/>
    <emitter type="area"><rgb name="radiance" value="4, 3, 2"/></emitter>
  </shape>
  <emitter type="constant"><spectrum name="radiance" value="0.3"/></emitter>
""",
    "textures": """
  <shape type="sphere"><point name="center" x="-0.6" y="0.5" z="0"/>
    <float name="radius" value="0.5"/><bsdf type="diffuse">
    <texture name="reflectance" type="bitmap">
      <string name="filename" value="noise.png"/></texture></bsdf></shape>
  <shape type="sphere"><point name="center" x="0.6" y="0.5" z="0"/>
    <float name="radius" value="0.5"/><bsdf type="diffuse">
    <texture name="reflectance" type="curvature"/></bsdf></shape>
  <emitter type="directional"><vector name="direction" x="0.2" y="-1"
    z="-0.3"/><rgb name="irradiance" value="3"/></emitter>
""",
    "lights": """
  <shape type="sphere"><point name="center" x="0" y="0.5" z="0"/>
    <float name="radius" value="0.5"/><bsdf type="roughplastic"/></shape>
  <shape type="disk"><transform name="toWorld"><scale value="0.3"/>
    <rotate x="1" angle="90"/><translate y="2"/></transform>
    <emitter type="area"><blackbody name="radiance" temperature="3500"
      scale="5e-5"/></emitter></shape>
  <emitter type="point"><point name="position" x="1" y="1.5" z="1"/>
    <spectrum name="intensity" value="400:1, 500:4, 600:6, 700:2"/>
  </emitter>
""",
}


def write_plugin_files():
    pos, idx = displaced_sphere(800)
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in pos / 0.08]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in idx]
    with open(os.path.join(XML_DIR, "grid.obj"), "w") as f:
        f.write("\n".join(lines) + "\n")
    meshes = [mesh_mod.TriMesh(pos / 0.08 * s, idx, name=f"ball{k}")
              for k, s in enumerate((1.0, 0.8))]
    mesh_mod.save_serialized(os.path.join(XML_DIR, "grid.serialized"),
                             meshes)
    gen = np.random.default_rng(9)
    png.write_png(os.path.join(XML_DIR, "noise.png"),
                  gen.random((32, 64, 3)).astype(np.float32))


def xml_plugins_phase(dev):
    os.makedirs(XML_DIR, exist_ok=True)
    write_plugin_files()
    for name, body in PLUGIN_XML.items():
        film = HDR_FILM
        if name == "lights":  # the ldrfilm, Reinhard tone mapped
            film = ('<film type="ldrfilm"><integer name="width" value="64"/>'
                    '<integer name="height" value="64"/><string '
                    'name="tonemapMethod" value="reinhard"/></film>')
        path = xml_file(f"{name}.xml", PLUGIN_HEAD.format(film=film) + body
                        + "</scene>\n")
        cuda_scene, settings = scene_xml.load_scene(path, device=dev)
        cpu_scene, _ = scene_xml.load_scene(path, device="cpu")
        parity_gate(f"xml plugins {name} 64^2 depth 3",
                    path_luminance(cuda_scene, 64, 3),
                    path_luminance(cpu_scene, 64, 3))
        if name == "lights":
            out = os.path.join(XML_DIR, "lights.png")
            run_cli(path, "-o", out)
            ldr = png.read_png(out)
            log(f"[xml plugins] ldrfilm tonemap {settings.tonemap}: PNG "
                f"{ldr.shape}, mean {ldr.mean():.4f}")
            if (settings.tonemap != "reinhard" or ldr.shape != (64, 64, 3)
                    or not 0.0 < ldr.mean() < 1.0):
                raise AssertionError("implausible Reinhard PNG")
    return len(PLUGIN_XML)


# ---------------------------------------------------------------------------
# motion blur, instancing, woven cloth, the other integrators, the tiled film
# ---------------------------------------------------------------------------

FLOP_LERP = 3  # one lerped plane value: two products and a sum
BIG_TILED = 4096  # the tiled film phase's image side
M_TIMES = (0.0, 0.37, 1.0)  # shutter times of the motion mode's checks


def film_values(scene, settings, res, spp=1):
    """Per-pixel channel sum of a render_film at res^2 (the settings'
    integrator, sampler and filter; CPU numpy)."""
    st = dataclasses.replace(settings, width=res, height=res)
    return develop(render_film(scene, st, spp=spp)).sum(-1).cpu().numpy()


def launch_counts():
    return dict(closest=ci.closest_tris_v.launches,
                anyhit=ci.anyhit_tris_v.launches,
                hier_closest=ch.hier_closest.launches,
                hier_anyhit=ch.hier_anyhit.launches,
                motion_closest=ch.hier_closest.motion_launches,
                motion_anyhit=ch.hier_anyhit.motion_launches)


def counted_render(tag, scene, settings, expect):
    """render_film with every count set to 0 first; raises unless the
    counts are ``expect`` (the keys given; the others 0).  Returns (film,
    counts, peak GiB)."""
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    film = render_film(scene, settings)
    torch.cuda.synchronize()
    got = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: expect.get(k, 0) for k in got}
    log(f"[{tag}] render_film {settings.width}x{settings.height} spp "
        f"{settings.spp} integrator {settings.integrator}: launches "
        + ", ".join(f"{k} {v}" for k, v in got.items() if v or want[k])
        + f"; peak device memory {peak:.3f} GiB")
    if got != want:
        raise AssertionError(f"[{tag}] expected launches {want}, got {got}")
    return film, got, peak


def check_image(tag, img, lo=0.02, hi=50.0):
    lum = luminance(img)
    if not np.isfinite(img).all() or (img < 0).any():
        raise AssertionError(f"[{tag}] non-finite or negative pixels")
    if not lo < lum.mean() < hi:
        raise AssertionError(f"[{tag}] implausible mean luminance "
                             f"{lum.mean()}")
    return lum


def motion_large_phase(dev):
    """29. [motion large]: the large scene's mesh deformable; the hierarchy
    kernels' motion mode against the plain version and the static mode;
    render_film at 768^2 depth 3 2 spp; card vs CPU at 64^2."""
    t0 = time.perf_counter()
    scene, settings = large_scene(dev, motion=True)
    h = scene.clusters
    log(f"[motion large] scene built on the host in "
        f"{time.perf_counter() - t0:.2f} s: {scene.geom.n_tris} triangles, "
        f"motion hierarchy {h.has_motion}, {h.n_supers} supers, frame 1 "
        f"moved {MOTION_SHIFT} along x")
    gen = torch.Generator(device=dev).manual_seed(77)
    n = L_RES * L_RES
    _, o, d = camera_rays(scene, L_RES)
    err, flips, cam = 0.0, 0, {}
    for t in M_TIMES:
        ht = h.at_time(t)
        e, f, cnt = check_hier(f"motion camera 768^2 t={t}", ht, o, d,
                               EPSILON, 1e30)
        cam[t] = cnt
        tt, _, _, _, _, found = ch.hier_closest(ht, o, d, EPSILON, 1e30)
        p, w, tmax = shadow_rays(scene, o, d, tt, found, gen)
        e2, f2, _ = check_hier(f"motion shadow rays t={t}", ht, p, w,
                               EPSILON, tmax, found)
        err, flips = max(err, e, e2), flips + f + f2
    # at t = 0 the motion mode is the static kernel on frame 0's rows
    static = dataclasses.replace(h, has_motion=False)
    h0 = h.at_time(0.0)
    a = ch.hier_closest(h0, o, d, EPSILON, 1e30)
    b = ch.hier_closest(static, o, d, EPSILON, 1e30)
    p, w, tmax = shadow_rays(scene, o, d, a[0], a[5], gen)
    ab = ch.hier_anyhit(h0, p, w, EPSILON, tmax, a[5])
    bb = ch.hier_anyhit(static, p, w, EPSILON, tmax, a[5])
    torch.cuda.synchronize()
    m0 = mismatches(a, b) + mismatches((ab,), (bb,))
    log(f"[motion large] t=0 motion mode vs static kernel on frame 0: "
        f"mismatches {m0}")
    if m0:
        raise AssertionError("the motion mode at t = 0 is not the static "
                             "kernel")
    ht = h.at_time(0.37)
    tt, _, _, _, _, found = ch.hier_closest(ht, o, d, EPSILON, 1e30)
    p, w, tmax = shadow_rays(scene, o, d, tt, found, gen)
    calls = {"motion_closest": lambda: ch.hier_closest(ht, o, d, EPSILON,
                                                       1e30),
             "static_closest": lambda: ch.hier_closest(static, o, d,
                                                       EPSILON, 1e30),
             "motion_anyhit": lambda: ch.hier_anyhit(ht, p, w, EPSILON, tmax,
                                                     found),
             "static_anyhit": lambda: ch.hier_anyhit(static, p, w, EPSILON,
                                                     tmax, found)}
    timing = median_ms_in_turns(calls, 11)
    for k, v in device_ms_in_turns(calls, 11, names=HIER_KERNELS).items():
        timing[f"{k}_device"] = v
    timing.update(median_ms_in_turns({
        "motion_closest_plain": lambda: hy.intersect_hierarchy_plain(
            ht, o, d, EPSILON, 1e30),
        "motion_anyhit_plain": lambda: hy.intersect_hierarchy_plain(
            ht, p, w, EPSILON, tmax, any_hit=True, active=found)}, 1))
    sh = hy.intersect_hierarchy_plain(ht, p, w, EPSILON, tmax, any_hit=True,
                                      active=found)[1]
    tables = hier_table_bytes(h) + h.blocks1.numel() * 4

    def flops(cnt):
        # the function lerps each cluster row once a call; the kernel's
        # lerp at every cluster test is work of its design, not counted
        return hier_flops(h, cnt) + h.blocks1.shape[0] * hy.LEAF * 9 * \
            FLOP_LERP

    timing["motion_closest_bound"] = bound(n * (32 + 21) + tables,
                                           flops(cam[0.37]))
    timing["motion_anyhit_bound"] = bound(n * (32 + 1 + 1) + tables,
                                          flops(sh))
    log("[motion large] ms per call at 768^2, t=0.37 (median; static = the "
        "same tables through the static mode): "
        + ", ".join(f"{k} {fmt(v)}" for k, v in timing.items()
                    if not k.endswith("bound"))
        + "; bounds " + ", ".join(f"{k} {v[0]:.4f} ({v[1]})"
                                  for k, v in timing.items()
                                  if k.endswith("bound")))
    settings.spp = L_SPP
    film, got, peak = counted_render(
        "motion large", scene, settings,
        dict(hier_closest=L_DEPTH * L_SPP, hier_anyhit=(L_DEPTH - 1) * L_SPP,
             motion_closest=L_DEPTH * L_SPP,
             motion_anyhit=(L_DEPTH - 1) * L_SPP))
    img = develop(film).cpu().numpy()
    lum = check_image("motion large", img, 0.2, 1.5)
    q = L_RES // 8
    log(f"[motion large] image mean luminance {lum.mean():.5f}, centre "
        f"{lum[3 * q:5 * q, 3 * q:5 * q].mean():.5f}, pass times "
        f"{shutter_times(scene, L_SPP)}")
    per_pass = pass_time(scene, settings, 1, 3,
                         n * (1 + 2 * (L_DEPTH - 1)), "motion large")
    cpu_scene, _ = large_scene("cpu", motion=True)
    parity_gate(f"motion large 64^2 depth {L_DEPTH} 2 spp",
                film_values(scene, settings, 64, 2),
                film_values(cpu_scene, settings, 64, 2))
    return dict(err=err, flips=flips, timing=timing,
                launches=(got["motion_closest"], got["motion_anyhit"]),
                pass_ms=per_pass, peak=peak)


def shutter_times(scene, spp):
    from mitsuba_im_tpu_torch.render.job import shutter_time

    return [round(shutter_time(scene, s), 6) for s in range(spp)]


def motion_cornell_phase(dev):
    """30. [motion cornell]: a deformable quad sliding across the Cornell
    box, brute force on the lerped tables, 1024^2 depth 5 4 spp."""
    scene, settings = motion_cornell(dev)
    settings.width = settings.height = RES
    settings.spp = SPP
    settings.integrator_props = dict(max_depth=DEPTH)
    film, _, peak = counted_render(
        "motion cornell", scene, settings,
        dict(closest=DEPTH * SPP, anyhit=(DEPTH - 1) * SPP))
    img = develop(film).cpu().numpy()
    lum = check_image("motion cornell", img)
    still = develop(render_film(dataclasses.replace(
        scene.with_time(0.0), motion=None), settings)).cpu().numpy()
    moved = float(np.abs(luminance(still) - lum).mean())
    log(f"[motion cornell] mean luminance {lum.mean():.5f}; mean |blurred - "
        f"frame 0| {moved:.5f}; shutter times {shutter_times(scene, SPP)}")
    if moved < 1e-3:
        raise AssertionError("the deformable quad did not move")
    per_pass = pass_time(scene, settings, 2, 6,
                         RES * RES * (1 + 2 * (DEPTH - 1)), "motion cornell")
    cpu_scene, _ = motion_cornell("cpu")
    parity_gate("motion cornell 128^2 depth 5 2 spp",
                film_values(scene, settings, 128, 2),
                film_values(cpu_scene, settings, 128, 2))
    return dict(pass_ms=per_pass, peak=peak)


def instanced_phase(dev):
    """31. [instanced]: 16 instances of the 1,120,504-triangle mesh through
    the indirect route at 768^2 depth 3 2 spp; card vs CPU at 64^2; 4
    instances of a 100k-triangle mesh against the same scene expanded."""
    t0 = time.perf_counter()
    scene, settings = instanced_scene(dev)
    h = scene.clusters
    n_inst = scene.geom.inst_rot.shape[0] - 1
    log(f"[instanced] scene built on the host in "
        f"{time.perf_counter() - t0:.2f} s: {scene.geom.n_tris} triangles "
        f"stored, {n_inst} instances, {scene.geom.n_tris * n_inst} seen; "
        f"{h.n_supers} world supers, {h.blocks.shape[0]} cluster rows "
        f"(tables {hier_table_bytes(h) / 2**20:.1f} MiB)")
    _, o, d = camera_rays(scene, L_RES)
    check_hier("instanced camera 768^2", h, o, d, EPSILON, 1e30)
    settings.spp = L_SPP
    film, got, peak = counted_render(
        "instanced", scene, settings,
        dict(hier_closest=L_DEPTH * L_SPP, hier_anyhit=(L_DEPTH - 1) * L_SPP))
    img = develop(film).cpu().numpy()
    lum = check_image("instanced", img, 0.2, 1.5)
    log(f"[instanced] image mean luminance {lum.mean():.5f}")
    per_pass = pass_time(scene, settings, 1, 3,
                         L_RES * L_RES * (1 + 2 * (L_DEPTH - 1)), "instanced")
    cpu_scene, _ = instanced_scene("cpu")
    parity_gate(f"instanced 64^2 depth {L_DEPTH}",
                film_values(scene, settings, 64, 1),
                film_values(cpu_scene, settings, 64, 1))
    del scene, cpu_scene
    small, sset = instanced_scene(dev, n_side=2, n_tris_target=100_000)
    flat, fset = instanced_scene(dev, n_side=2, n_tris_target=100_000,
                                 expanded=True)
    log(f"[instanced] 4 instances of {small.geom.n_tris} triangles vs the "
        f"expanded scene of {flat.geom.n_tris}")
    parity_gate("4 instances vs expanded, card, 256^2",
                film_values(small, sset, 256, 2),
                film_values(flat, fset, 256, 2))
    return dict(pass_ms=per_pass, peak=peak,
                launches=(got["hier_closest"] // L_SPP,
                          got["hier_anyhit"] // L_SPP))


def irawan_phase(dev):
    """32. [irawan]: the Cornell box with the plain weave on the floor and
    the twill on the back wall, 1024^2 depth 5 4 spp; device operations
    per pass; card vs CPU at 128^2."""
    t0 = time.perf_counter()
    scene, settings = irawan_cornell(dev)
    log(f"[irawan] scene built in {time.perf_counter() - t0:.2f} s (the "
        f"normalization pre-pass of two patterns included), weaves "
        f"{[w.name for w in scene.bsdfs.weaves]}")
    settings.width = settings.height = RES
    settings.spp = SPP
    settings.integrator_props = dict(max_depth=DEPTH)
    film, _, peak = counted_render(
        "irawan", scene, settings,
        dict(closest=DEPTH * SPP, anyhit=(DEPTH - 1) * SPP))
    img = develop(film).cpu().numpy()
    lum = check_image("irawan", img)
    log(f"[irawan] mean luminance {lum.mean():.5f}, floor "
        f"{lum[-RES // 8:, RES // 3:-RES // 3].mean():.5f}")
    per_pass = pass_time(scene, settings, 2, 6,
                         RES * RES * (1 + 2 * (DEPTH - 1)), "irawan")
    prof = device_profile("irawan",
                          lambda k: render_film(scene, settings, spp=k))
    cpu_scene, _ = irawan_cornell("cpu")
    parity_gate("irawan cornell 128^2 depth 5",
                path_luminance(scene, 128, DEPTH),
                path_luminance(cpu_scene, 128, DEPTH))
    return dict(pass_ms=per_pass, peak=peak, prof=prof)


INTEGRATOR_XML = {
    "direct": '<integrator type="direct"><integer name="emitterSamples" '
              'value="2"/><integer name="bsdfSamples" value="2"/>'
              '</integrator>',
    "ao": '<integrator type="ao"><integer name="shadingSamples" value="4"/>'
          '</integrator>',
    "motion": '<integrator type="motion"/>',
    **{f"field {f}": f'<integrator type="field"><string name="field" '
                     f'value="{f}"/></integrator>' for f in FIELDS},
}
# closest-hit and any-hit launches a pass: the camera ray, direct's BSDF
# samples and its light samples, ao's shading samples
INTEGRATOR_LAUNCHES = {"direct": (3, 2), "ao": (1, 4)}


def with_integrator(xml, integrator):
    start = xml.index("<integrator")
    end = xml.index("</integrator>") + len("</integrator>")
    return xml[:start] + integrator + xml[end:]


def integrators_phase(dev, smi):
    """33. [integrators]: direct, ao, every field and motion from scene
    files through the command line, the XML Cornell at 1024^2 and direct
    and ao on the large scene (the files of phase 27) at 768^2; launches a
    pass, the pass time, card vs CPU."""
    out = {}
    base = CORNELL_XML.format(max_depth=DEPTH, spp=SPP, res=RES)
    cpu_cache = {}
    for name, xml in INTEGRATOR_XML.items():
        path = xml_file(f"int_{name.replace(' ', '_')}.xml",
                        with_integrator(base, xml))
        ci.reset_launch_counts()
        ch.reset_launch_counts()
        with Spy(scene_xml, "load_scene") as ld:
            run_cli(path, "-o", os.path.join(XML_DIR, "int.exr"))
        torch.cuda.synchronize()
        got = launch_counts()
        scene, settings = ld.result
        c, a = INTEGRATOR_LAUNCHES.get(name, (1, 0))
        want = dict(closest=c * SPP, anyhit=a * SPP)
        if {k: got[k] for k in got} != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"[integrators] {name}: expected {want}, "
                                 f"got {got}")
        img, _ = exr.read_exr(os.path.join(XML_DIR, "int.exr"))
        if not np.isfinite(img).all() or not np.abs(img).max() > 0:
            raise AssertionError(f"[integrators] {name}: empty image")
        per_pass = pass_time(scene, settings, 2, 6, RES * RES * (c + a),
                             f"integrators {name}")
        cpu = cpu_cache.get("cornell")
        if cpu is None:
            cpu = cpu_cache["cornell"] = scene_xml.load_scene(
                path, device="cpu")[0]
        parity_gate(f"{name} cornell 128^2",
                    film_values(scene, settings, 128, 1),
                    film_values(cpu, settings, 128, 1))
        out[name] = dict(launches=(c, a), pass_ms=per_pass)
    c = LARGE_CAMERA
    large = LARGE_XML.format(
        depth=L_DEPTH, fov=c["fov_deg"], res=L_RES, spp=L_SPP,
        **{k: ", ".join(map(str, c[k])) for k in ("origin", "target",
                                                    "up")})
    cpu = None
    for name in ("direct", "ao"):
        path = xml_file(f"int_large_{name}.xml",
                        with_integrator(large, INTEGRATOR_XML[name]))
        ci.reset_launch_counts()
        ch.reset_launch_counts()
        with Spy(scene_xml, "load_scene") as ld:
            run_cli(path, "-o", os.path.join(XML_DIR, "int_large.exr"))
        torch.cuda.synchronize()
        got = launch_counts()
        scene, settings = ld.result
        nc, na = INTEGRATOR_LAUNCHES[name]
        want = dict(hier_closest=nc * L_SPP, hier_anyhit=na * L_SPP)
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"[integrators] large {name}: expected "
                                 f"{want}, got {got}")
        per_pass = pass_time(scene, settings, 1, 3, L_RES * L_RES * (nc + na),
                             f"integrators large {name}")
        if cpu is None:
            cpu = scene_xml.load_scene(path, device="cpu")[0]
        parity_gate(f"{name} large 64^2", film_values(scene, settings, 64, 1),
                    film_values(cpu, settings, 64, 1))
        out[f"large {name}"] = dict(launches=(nc, na), pass_ms=per_pass)
    log("[integrators] " + "; ".join(
        f"{k}: launches {v['launches']}, pass {v['pass_ms']:.3f} ms"
        for k, v in out.items()) + f" ({smi})")
    return out


def tiled_phase(dev, smi):
    """34. [tiled]: the XML Cornell with tiledhdrfilm at 4096^2 through the
    command line, in bands of render_tiled's default height; its peak
    device memory against a full-frame 4096^2 pass's; at 1024^2 the tiled
    EXR (full precision, bands of 256 rows through render_tiled) against
    render_film's image."""
    from mitsuba_im_tpu_torch.film.tiled import render_tiled

    band = inspect.signature(render_tiled).parameters["band_rows"].default
    big = BIG_TILED
    xml = CORNELL_XML.format(max_depth=DEPTH, spp=1, res=big).replace(
        'film type="hdrfilm"', 'film type="tiledhdrfilm"')
    path = xml_file("tiled.xml", xml)
    out = os.path.join(XML_DIR, "tiled.exr")
    torch.cuda.reset_peak_memory_stats()
    ci.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli(path, "-o", out)
    torch.cuda.synchronize()
    tiled_s = time.perf_counter() - t0
    tiled_peak = torch.cuda.max_memory_allocated() / 2**30
    bands = -(-big // band)
    got = (ci.closest_tris_v.launches, ci.anyhit_tris_v.launches)
    if got != (DEPTH * bands, (DEPTH - 1) * bands):
        raise AssertionError(f"[tiled] launches {got}")
    img, _ = exr.read_exr(out)
    left, right = left_right(img)
    if img.shape != (big, big, 3) or not (left[0] > left[1]
                                          and right[1] > right[0]):
        raise AssertionError("[tiled] implausible tiled EXR")
    scene, settings = scene_xml.load_scene(path, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    render_film(scene, settings, spp=1)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    full_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[tiled] {big}^2 1 spp in {bands} bands of {band} rows: command line "
        f"{tiled_s:.2f} s (load, render, EXR), launches {got}, peak device "
        f"memory {tiled_peak:.3f} GiB; full-frame render_film pass "
        f"{full_s:.2f} s, peak {full_peak:.3f} GiB ({smi})")

    settings = dataclasses.replace(settings, width=RES, height=RES, spp=SPP)
    small = os.path.join(XML_DIR, "tiled_small.exr")
    render_tiled(scene, settings, small, band_rows=256, half=False)
    tiled = exr.read_exr(small)[0]
    ref = develop(render_film(scene, settings)).cpu().numpy()
    err = float(np.abs(tiled - ref).max())
    log(f"[tiled] {RES}^2 {SPP} spp tiled (bands of 256) vs render_film: "
        f"max |diff| {err:.3e}")
    if err > 2e-5:
        raise AssertionError("[tiled] the tiled film is not render_film's")
    return dict(tiled_peak=tiled_peak, full_peak=full_peak, tiled_s=tiled_s,
                full_s=full_s, err=err)


# ---------------------------------------------------------------------------
# participating media: the volumetric path tracer
# ---------------------------------------------------------------------------

V_PARITY_RES = 128  # both volume phases' card vs CPU image
V_SPP = 2  # volume_cornell's passes (its pass is host-bound, 1.1-1.6 s)
V_CLI_RES = 256  # the volume Cornell scene file through the command line

# volume_cornell's media as a scene file (the grids from .vol files)
VOLUME_MEDIA_XML = """
<medium type="homogeneous" id="fog">
  <rgb name="sigmaS" value="0.04"/><rgb name="sigmaA" value="0.01"/>
  <phase type="mixturephase"><string name="weights" value="0.6, 0.4"/>
    <phase type="hg"><float name="g" value="0.7"/></phase>
    <phase type="rayleigh"/></phase></medium>
<medium type="homogeneous" id="homog">
  <rgb name="sigmaS" value="2.0, 1.6, 1.2"/><rgb name="sigmaA" value="0.1"/>
  <phase type="hg"><float name="g" value="0.6"/></phase></medium>
<medium type="heterogeneous" id="cloud"><float name="scale" value="6"/>
  <volume name="density" type="gridvolume">
    <string name="filename" value="cloud.vol"/></volume>
  <volume name="albedo" type="constvolume">
    <float name="value" value="0.9"/></volume>
  <volume name="orientation" type="gridvolume">
    <string name="filename" value="swirl.vol"/></volume>
  <phase type="microflake"><float name="stddev" value="0.3"/></phase>
</medium>
<medium type="homogeneous" id="kkay">
  <rgb name="sigmaT" value="1.5"/><rgb name="albedo" value="0.8"/>
  <phase type="kkay"/></medium>
"""


def segment_rays(scene, settings, res):
    """(o, d, tmin, tmax) of the first bounce's shadow segments in one
    volpath pass at res^2, as the pass hands them to the intersector: its
    second to (1 + MAX_NULL_SEGMENTS)th intersection calls."""
    calls = []
    orig = isect.intersect_v

    def spy(geom, o, d, tmin, tmax, **kw):
        if len(calls) <= MAX_NULL_SEGMENTS:
            calls.append((o, d, tmin, tmax))
        return orig(geom, o, d, tmin, tmax, **kw)

    isect.intersect_v = spy
    try:
        render_film(scene, dataclasses.replace(settings, width=res,
                                               height=res), spp=1)
    finally:
        isect.intersect_v = orig
    segs = calls[1:]
    if len(segs) != MAX_NULL_SEGMENTS or not all(
            isinstance(t, torch.Tensor) for *_, t in segs):
        raise AssertionError("the pass did not march its shadow segments")
    return segs


def volume_render(tag, scene, settings, expect, rays):
    """counted_render with the tracking counts reset first; then the pass
    time, the device profile and the tracking loops' iterations and host
    syncs a pass."""
    med.reset_track_stats()
    film, got, peak = counted_render(tag, scene, settings, expect)
    iters = med.TRACK_STATS["iterations"] / settings.spp
    ran = med.TRACK_STATS["executed"] / settings.spp
    syncs = med.TRACK_STATS["syncs"] / settings.spp
    log(f"[{tag}] tracking loops: {iters:.1f} iterations a pass as the "
        f"batch counts them, {ran:.1f} of them run (the rest skipped beyond "
        f"reach), {syncs:.1f} host syncs a pass")
    per_pass, turns = pass_time_turns(scene, settings, rays, tag)
    prof = device_profile(tag, lambda k: render_film(scene, settings,
                                                     spp=k))
    return film, dict(launches=got, peak=peak, iters=iters, ran=ran,
                      syncs=syncs, pass_ms=per_pass, turns=turns, prof=prof)


def pass_time_turns(scene, settings, rays, tag, rounds=2, fn=render_film):
    """Per-pass ms as the median of ``rounds`` differences of a 2-pass and
    a 1-pass render (``fn``: render_film, or job.render for the
    integrators with loops of their own) timed in turns (one warm-up pass
    first); the differences show how far a host-bound pass spreads within
    one run."""
    def run(k):
        return lambda: fn(scene, settings, spp=k)

    run(1)()
    turns = []
    for _ in range(rounds):
        t1 = cuda_ms(run(1), 1, warm=False)
        t2 = cuda_ms(run(2), 1, warm=False)
        turns.append(t2 - t1)
    per_pass = statistics.median(turns)
    log(f"[{tag}] pass time {per_pass:.3f} ms (median of 2 - 1 passes in "
        f"turns: {', '.join(f'{t:.3f}' for t in turns)} ms); {rays} rays per "
        f"pass; {rays / (per_pass * 1e-3):.4e} rays/s")
    return per_pass, turns


def volume_cornell_phase(dev, smi):
    """35. [volume cornell]: volume_cornell through render_film with
    volpath at 1024^2, depth 5, 2 spp; tri_closest on the first bounce's
    shadow segments; card vs CPU at 128^2."""
    t0 = time.perf_counter()
    scene, settings = volume_cornell(dev)
    log(f"[volume cornell] scene built in {time.perf_counter() - t0:.2f} s: "
        f"{scene.geom.n_tris} triangles, {scene.media.n_media} media, "
        f"density atlas {scene.media.density_atlas.numel() * 4 / 2**20:.3f} "
        f"MiB, phases {scene.media.used_phase}")
    settings.width = settings.height = RES
    settings.spp = V_SPP
    bounce = 1 + MAX_NULL_SEGMENTS
    film, out = volume_render(
        "volume cornell", scene, settings,
        dict(closest=DEPTH * bounce * V_SPP), RES * RES * DEPTH * bounce)
    img = develop(film).cpu().numpy()
    lum = check_image("volume cornell", img)
    left, right = left_right(img)
    log(f"[volume cornell] mean luminance {lum.mean():.5f}, left rgb "
        f"{np.round(left, 4).tolist()}, right rgb "
        f"{np.round(right, 4).tolist()}")
    if not (left[0] > left[1] and right[1] > right[0]):
        raise AssertionError("[volume cornell] red wall not on the left / "
                             "green not on the right")
    err = 0.0
    for k, (o, d, tmin, tmax) in enumerate(segment_rays(scene, settings,
                                                        RES)):
        e = check_tri(f"volume cornell shadow segment {k + 1}", dict(
            geom=scene.geom, o=o, d=d,
            forms=[("segment tmin, per-ray tmax", tmin, tmax)]))
        err = max(err, e["closest"])
    out_cli = volume_cli(dev, scene)
    cpu_scene, _ = volume_cornell("cpu")
    med.reset_track_stats()
    card = film_values(scene, settings, V_PARITY_RES)
    card_iters = med.TRACK_STATS["iterations"]
    med.reset_track_stats()
    cpu = film_values(cpu_scene, settings, V_PARITY_RES)
    cpu_iters = med.TRACK_STATS["iterations"]
    log(f"[volume cornell] tracking iterations at {V_PARITY_RES}^2: card "
        f"{card_iters}, CPU {cpu_iters}")
    if card_iters != cpu_iters:
        raise AssertionError("[volume cornell] the card's tracking loops ran "
                             "another number of iterations than the CPU's")
    parity_gate(f"volume cornell {V_PARITY_RES}^2 depth {DEPTH}", card, cpu)
    out.update(err=err, launches_per_pass=out["launches"]["closest"] // V_SPP,
               cli=out_cli)
    log(f"[volume cornell] pass {out['pass_ms']:.3f} ms, peak "
        f"{out['peak']:.3f} GiB ({smi})")
    return out


def volume_cli(dev, scene):
    """volume_cornell as a scene file (the icosahedra from an OBJ file, the
    grids from .vol files, the XML Cornell box's walls) through the command
    line on the card at V_CLI_RES^2, depth 5, 1 spp: 25 + 0 launches, the
    EXR render_film's film; its media tables are ``scene``'s."""
    os.makedirs(XML_DIR, exist_ok=True)
    grid = volume_records()[2]
    for name, rec in (("cloud.vol", grid["density"]),
                      ("swirl.vol", grid["orientation"])):
        write_vol(os.path.join(XML_DIR, name), rec["data"], rec["bmin"],
                  rec["bmax"])
    ico = icosahedron((0.0, 0.0, 0.0), 1.0)
    with open(os.path.join(XML_DIR, "ico.obj"), "w") as f:
        f.write("".join(f"v {x!r} {y!r} {z!r}\n" for x, y, z in
                        ico.positions))
        f.write("".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in
                        ico.indices))
    shapes = "".join(
        '<shape type="obj"><string name="filename" value="ico.obj"/>'
        '<boolean name="faceNormals" value="true"/><transform '
        f'name="toWorld"><scale value="{VOLUME_RADIUS}"/><translate '
        f'x="{c[0]}" y="{c[1]}" z="{c[2]}"/></transform>{bsdf}<ref '
        f'name="interior" id="{mid}"/><ref name="exterior" id="fog"/>'
        '</shape>'
        for c, bsdf, mid in zip(
            VOLUME_CENTRES, ('<bsdf type="null"/>',) * 2
            + ('<bsdf type="dielectric"><float name="intIOR" value="1.33"/>'
               '</bsdf>',), ("homog", "cloud", "kkay")))
    xml = CORNELL_XML.format(max_depth=DEPTH, spp=1, res=V_CLI_RES).replace(
        '<integrator type="path">', '<integrator type="volpath">').replace(
        '<sensor type="perspective">', VOLUME_MEDIA_XML
        + '<sensor type="perspective"><ref name="exterior" id="fog"/>'
    ).replace("</scene>", shapes + "</scene>")
    path = xml_file("volume_cornell.xml", xml)
    out = os.path.join(XML_DIR, "volume_cornell.exr")
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    t0 = time.perf_counter()
    with Spy(scene_xml, "load_scene") as ld:
        run_cli(path, "-o", out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launch_counts()
    want = dict(closest=DEPTH * (1 + MAX_NULL_SEGMENTS))
    if got != {k: want.get(k, 0) for k in got}:
        raise AssertionError(f"[volume cornell] command line launches {got}")
    cli_scene, settings = ld.result
    for k in med.MEDIUM_LEAVES:
        if not torch.equal(getattr(cli_scene.media, k),
                           getattr(scene.media, k)):
            raise AssertionError(f"[volume cornell] media.{k} of the file "
                                 "differs from volume_cornell's")
    img, _ = exr.read_exr(out)
    ref = develop(render_film(cli_scene, settings)).cpu().numpy()
    diff = int((img != ref.astype(np.float16).astype(np.float32)).sum())
    log(f"[volume cornell] command line {V_CLI_RES}^2 1 spp: {seconds:.2f} s "
        f"(load, render, EXR), launches {got['closest']} + "
        f"{got['anyhit']}, EXR entries unlike render_film's (half) {diff}, "
        f"mean {img.mean():.5f}")
    if diff or not np.isfinite(img).all() or not img.mean() > 0.02:
        raise AssertionError("[volume cornell] the command line's EXR")
    return dict(seconds=seconds, launches=got)


def volume_large_phase(dev, smi):
    """36. [volume large]: volume_large through render_film with volpath at
    768^2, depth 3, 2 spp; hier_closest on the first bounce's shadow
    segments; card vs CPU at 128^2."""
    t0 = time.perf_counter()
    scene, settings = volume_large(dev)
    log(f"[volume large] scene built on the host in "
        f"{time.perf_counter() - t0:.2f} s: {scene.geom.n_tris} triangles, "
        f"{scene.clusters.n_supers} supers")
    bounce = 1 + MAX_NULL_SEGMENTS
    film, out = volume_render(
        "volume large", scene, settings,
        dict(hier_closest=L_DEPTH * bounce * L_SPP),
        L_RES * L_RES * L_DEPTH * bounce)
    img = develop(film).cpu().numpy()
    lum = check_image("volume large", img)
    corners = lum[[0, 0, -1, -1], [0, -1, 0, -1]]
    centre = lum[L_RES // 2 - 8:L_RES // 2 + 8,
                 L_RES // 2 - 8:L_RES // 2 + 8].mean()
    log(f"[volume large] corners luminance {np.round(corners, 5).tolist()}, "
        f"centre {centre:.5f}, mean {lum.mean():.5f}")
    if not (np.abs(corners - 1.0) < 1e-4).all() or not 0.05 < centre < 1.0:
        raise AssertionError("[volume large] the environment or the medium "
                             "is not where it should be")
    err = 0.0
    for k, (o, d, tmin, tmax) in enumerate(segment_rays(scene, settings,
                                                        L_RES)):
        e, _, _ = check_hier(f"volume large shadow segment {k + 1}",
                             scene.clusters, o, d, tmin, tmax)
        err = max(err, e)
    cpu_scene, _ = volume_large("cpu")
    parity_gate(f"volume large {V_PARITY_RES}^2 depth {L_DEPTH}",
                film_values(scene, settings, V_PARITY_RES),
                film_values(cpu_scene, settings, V_PARITY_RES))
    out.update(err=err,
               launches_per_pass=out["launches"]["hier_closest"] // L_SPP)
    log(f"[volume large] pass {out['pass_ms']:.3f} ms, peak "
        f"{out['peak']:.3f} GiB ({smi})")
    return out


# ---------------------------------------------------------------------------
# light tracing and bidirectional path tracing
# ---------------------------------------------------------------------------

B_PARITY_RES = 128  # the Cornell and volume phases' card vs CPU images
B_MEAN_SPP = (16, 8)  # path / bdpt passes of the 128^2 mean comparisons
# volume_cornell's mean comparison: a pass is host-bound on its tracking
# loops, so the samples come from a larger image, not from more passes
V_MEAN_RES = 1024
V_MEAN_SPP = (4, 2)  # volpath / bdpt passes
PT_MEAN_SPP = (16, 32)  # path / ptracer passes


def loop_settings(settings, integrator, res=None, spp=None, depth=None,
                  **props):
    """The settings with another integrator (its properties the depth and
    ``props``), image side and passes."""
    ip = dict(settings.integrator_props)
    if depth is not None:
        ip["max_depth"] = depth
    ip.update(props)
    return dataclasses.replace(
        settings, integrator=integrator, integrator_props=ip,
        width=res or settings.width, height=res or settings.height,
        spp=spp or settings.spp)


def counted_image(tag, scene, settings, expect):
    """job.render with every count set to 0 first; raises unless the
    counts are ``expect`` per pass (the keys given; the others 0).
    Returns (image numpy, counts, peak GiB)."""
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    img = job.render(scene, settings).cpu().numpy()
    torch.cuda.synchronize()
    got = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: expect.get(k, 0) * settings.spp for k in got}
    log(f"[{tag}] render {settings.width}x{settings.height} spp "
        f"{settings.spp} integrator {settings.integrator}: launches "
        + ", ".join(f"{k} {v}" for k, v in got.items() if v or want[k])
        + f"; peak device memory {peak:.3f} GiB")
    if got != want:
        raise AssertionError(f"[{tag}] expected launches {want}, got {got}")
    return img, got, peak


def loop_measures(tag, scene, settings, rays):
    """The pass time in turns, and the device operations, device time and
    idle share a pass (torch.profiler) of job.render."""
    per_pass, turns = pass_time_turns(scene, settings, rays, tag,
                                      fn=job.render)
    prof = device_profile(tag, lambda k: job.render(scene, settings,
                                                    spp=k), top=4)
    return dict(pass_ms=per_pass, turns=turns, prof=prof)


def occluded_calls(scene, settings, keep):
    """(o, d, tmin, tmax) of the any-hit calls ``keep`` (indices) of one
    pass of job.render, as the integrator hands them to the intersector."""
    calls, orig = [], isect.occluded_v

    def spy(geom, o, d, tmin, tmax, **kw):
        calls.append((o, d, tmin, tmax))
        return orig(geom, o, d, tmin, tmax, **kw)

    isect.occluded_v = spy
    try:
        job.render(scene, settings, spp=1)
    finally:
        isect.occluded_v = orig
    return [calls[k] for k in keep]


def image_values(scene, settings, res, spp=1):
    """Per-pixel channel sum of job.render at res^2 (CPU numpy)."""
    st = dataclasses.replace(settings, width=res, height=res)
    return job.render(scene, st, spp=spp).sum(-1).cpu().numpy()


def mean_against(tag, img, ref, rtol, channel_rtol=None, box=None):
    """Raises unless img's mean is within rtol of ref's (and each
    channel's within channel_rtol); ``box`` (rows, columns) compares a
    region too."""
    out = {}
    for name, sl in (("image", (slice(None), slice(None))),
                     ("region", box)):
        if sl is None:
            continue
        a, b = img[sl], ref[sl]
        rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
        ch_rel = (np.abs(a.mean((0, 1)) - b.mean((0, 1)))
                  / b.mean((0, 1))).max()
        log(f"[{tag}] {name} mean {a.mean():.5f} against {b.mean():.5f}: "
            f"rel {rel:.4f}, largest channel rel {ch_rel:.4f}")
        if rel >= rtol or (channel_rtol and ch_rel >= channel_rtol):
            raise AssertionError(f"[{tag}] {name} mean out of its limit")
        out[name] = rel
    return out


def ptracer_cornell_phase(dev, smi):
    """37. [ptracer cornell]: the particle tracer on _tiny_cornell at
    1024^2, depth 5, 2^20 particles a pass, 4 passes, the box film."""
    scene, settings = tiny_cornell(dev)
    settings = loop_settings(settings, "ptracer", RES, SPP, DEPTH)
    img, got, peak = counted_image("ptracer cornell", scene, settings,
                                   dict(closest=DEPTH, anyhit=DEPTH))
    lum = check_image("ptracer cornell", img)
    left, right = left_right(img)
    log(f"[ptracer cornell] mean luminance {lum.mean():.5f}, left rgb "
        f"{np.round(left, 4).tolist()}, right rgb "
        f"{np.round(right, 4).tolist()}")
    if not (left[0] > left[1] and right[1] > right[0]):
        raise AssertionError("[ptracer cornell] red wall not on the left / "
                             "green not on the right")
    out = loop_measures("ptracer cornell", scene, settings,
                        RES * RES * 2 * DEPTH)
    # the first bounce's camera connections (the second any-hit call)
    o, d, tmin, tmax = occluded_calls(scene, settings, [1])[0]
    err = check_tri("ptracer cornell first-bounce connections", dict(
        geom=scene.geom, o=o, d=d,
        forms=[("connection tmin, per-ray tmax", tmin, tmax)]))
    cpu_scene, _ = tiny_cornell("cpu")
    parity_gate(f"ptracer cornell {B_PARITY_RES}^2 depth {DEPTH}",
                image_values(scene, settings, B_PARITY_RES),
                image_values(cpu_scene, settings, B_PARITY_RES))
    small = loop_settings(settings, "ptracer", B_PARITY_RES)
    path = job.render(scene, loop_settings(small, "path"),
                      spp=PT_MEAN_SPP[0]).cpu().numpy()
    pt = job.render(scene, small, spp=PT_MEAN_SPP[1]).cpu().numpy()
    mean_against("ptracer cornell", pt, path, 0.05)
    out.update(launches=got, peak=peak, err=err,
               per_pass=(got["closest"] // SPP, got["anyhit"] // SPP))
    log(f"[ptracer cornell] pass {out['pass_ms']:.3f} ms, peak "
        f"{peak:.3f} GiB ({smi})")
    return out


def ptracer_lights_phase(dev, smi):
    """38. [ptracer lights]: lights_cornell's emitters (triangle, sphere
    and disk area lights, point, spot, collimated) as particle origins,
    card vs CPU at 128^2."""
    scene, settings = lights_cornell(dev)
    cpu_scene, _ = lights_cornell("cpu")
    settings = loop_settings(settings, "ptracer", depth=DEPTH)
    card = image_values(scene, settings, B_PARITY_RES)
    if not card.mean() > 0:
        raise AssertionError("[ptracer lights] black image")
    parity_gate(f"ptracer lights_cornell {B_PARITY_RES}^2 depth {DEPTH} "
                f"({smi})", card,
                image_values(cpu_scene, settings, B_PARITY_RES))


def bdpt_cornell_phase(dev, smi):
    """39. [bdpt cornell]: bdpt on _tiny_cornell at 1024^2, depth 5, 4
    spp, the light image on."""
    scene, settings = tiny_cornell(dev)
    settings = loop_settings(settings, "bdpt", RES, SPP, DEPTH,
                             light_image=True)
    n_any = 2 * (DEPTH - 1) + (DEPTH - 2) * (DEPTH - 1) // 2
    img, got, peak = counted_image(
        "bdpt cornell", scene, settings,
        dict(closest=2 * DEPTH - 1, anyhit=n_any))
    lum = check_image("bdpt cornell", img)
    left, right = left_right(img)
    log(f"[bdpt cornell] mean luminance {lum.mean():.5f}, left rgb "
        f"{np.round(left, 4).tolist()}, right rgb "
        f"{np.round(right, 4).tolist()}")
    if not (left[0] > left[1] and right[1] > right[0]):
        raise AssertionError("[bdpt cornell] red wall not on the left / "
                             "green not on the right")
    out = loop_measures("bdpt cornell", scene, settings,
                        RES * RES * (2 * DEPTH - 1 + n_any))
    # the first inner connection (s = 2, t = 2): after the DEPTH - 1 NEE
    # and DEPTH - 1 camera connections
    o, d, tmin, tmax = occluded_calls(scene, settings,
                                      [2 * (DEPTH - 1)])[0]
    err = check_tri("bdpt cornell inner connection segments", dict(
        geom=scene.geom, o=o, d=d,
        forms=[("segment tmin, per-ray tmax", tmin, tmax)]))
    cpu_scene, _ = tiny_cornell("cpu")
    parity_gate(f"bdpt cornell {B_PARITY_RES}^2 depth {DEPTH}",
                image_values(scene, settings, B_PARITY_RES),
                image_values(cpu_scene, settings, B_PARITY_RES))
    small = loop_settings(settings, "bdpt", B_PARITY_RES)
    path = job.render(scene, loop_settings(small, "path"),
                      spp=B_MEAN_SPP[0]).cpu().numpy()
    bd = job.render(scene, small, spp=B_MEAN_SPP[1]).cpu().numpy()
    mean_against("bdpt cornell", bd, path, 0.05, 0.08)
    out.update(launches=got, peak=peak, err=err,
               per_pass=(got["closest"] // SPP, got["anyhit"] // SPP))
    log(f"[bdpt cornell] pass {out['pass_ms']:.3f} ms, peak {peak:.3f} GiB "
        f"({smi})")
    return out


def bdpt_large_phase(dev, smi):
    """40. [bdpt large]: bdpt on large_scene() (1,120,504 triangles under
    the unit constant environment: light subpaths from its disk) at 768^2,
    depth 3, 2 spp; both hierarchy kernels bit for bit on its inner
    connection's segments; card vs CPU at 64^2."""
    scene, settings = large_scene(dev)
    settings = loop_settings(settings, "bdpt", L_RES, L_SPP, L_DEPTH)
    n_any = 2 * (L_DEPTH - 1) + (L_DEPTH - 2) * (L_DEPTH - 1) // 2
    img, got, peak = counted_image(
        "bdpt large", scene, settings,
        dict(hier_closest=2 * L_DEPTH - 1, hier_anyhit=n_any))
    lum = check_image("bdpt large", img)
    corners = lum[[0, 0, -1, -1], [0, -1, 0, -1]]
    centre = lum[L_RES // 2 - 8:L_RES // 2 + 8,
                 L_RES // 2 - 8:L_RES // 2 + 8].mean()
    log(f"[bdpt large] corners luminance {np.round(corners, 5).tolist()}, "
        f"centre {centre:.5f}, mean {lum.mean():.5f}")
    if not (np.abs(corners - 1.0) < 1e-3).all() or not 0.05 < centre < 1.0:
        raise AssertionError("[bdpt large] the environment or the mesh is "
                             "not where it should be")
    out = loop_measures("bdpt large", scene, settings,
                        L_RES * L_RES * (2 * L_DEPTH - 1 + n_any))
    # the inner connection (s = 2, t = 2): after the NEE and the camera
    # connections
    o, d, tmin, tmax = occluded_calls(scene, settings,
                                      [2 * (L_DEPTH - 1)])[0]
    err, _, _ = check_hier("bdpt large inner connection segments",
                           scene.clusters, o, d, tmin, tmax)
    cpu_scene, _ = large_scene("cpu")
    parity_gate(f"bdpt large 64^2 depth {L_DEPTH}",
                image_values(scene, settings, 64),
                image_values(cpu_scene, settings, 64))
    out.update(launches=got, peak=peak, err=err,
               per_pass=(got["hier_closest"] // L_SPP,
                         got["hier_anyhit"] // L_SPP))
    log(f"[bdpt large] pass {out['pass_ms']:.3f} ms, peak {peak:.3f} GiB "
        f"({smi})")
    return out


def projected_box(scene, centre, radius, res):
    """(rows, columns) of the square inside the silhouette of a sphere of
    ``radius`` at ``centre`` on a res^2 film (0.7 of its projected radius
    around its centre's pixel)."""
    pts = V3(*(torch.tensor([float(centre[k]), float(centre[k])
                             + (radius if k == 1 else 0.0)],
                            device=scene.device) for k in range(3)))
    u, w, *_ = connect_v(scene.sensor, pts)
    cx, cy = float(u[0]) * res, float(w[0]) * res
    r = max(abs(float(w[1] - w[0])) * res * 0.7, 1.0)
    return (slice(int(cy - r), int(cy + r) + 1),
            slice(int(cx - r), int(cx + r) + 1))


def bdpt_volume_phase(dev, smi):
    """41. [bdpt volume]: bdpt on volume_cornell at 128^2, depth 5: card vs
    CPU; its mean against the card's volpath over the image and inside
    the Kajiya-Kay icosahedron (the port's phase functions, ROADMAP
    C16)."""
    t0 = time.perf_counter()
    scene, settings = volume_cornell(dev)
    cpu_scene, _ = volume_cornell("cpu")
    settings = loop_settings(settings, "bdpt", B_PARITY_RES, 1, DEPTH)
    med.reset_track_stats()
    card = image_values(scene, settings, B_PARITY_RES)
    card_iters = med.TRACK_STATS["iterations"]
    med.reset_track_stats()
    cpu = image_values(cpu_scene, settings, B_PARITY_RES)
    cpu_iters = med.TRACK_STATS["iterations"]
    log(f"[bdpt volume] tracking iterations at {B_PARITY_RES}^2: card "
        f"{card_iters}, CPU {cpu_iters}")
    parity_gate(f"bdpt volume cornell {B_PARITY_RES}^2 depth {DEPTH}",
                card, cpu)
    big = loop_settings(settings, "bdpt", V_MEAN_RES)
    ci.reset_launch_counts()
    med.reset_track_stats()
    t1 = time.perf_counter()
    bd = job.render(scene, big, spp=V_MEAN_SPP[1]).cpu().numpy()
    torch.cuda.synchronize()
    bd_s = time.perf_counter() - t1
    got = launch_counts()
    log(f"[bdpt volume] tracking loops: "
        f"{med.TRACK_STATS['iterations'] / V_MEAN_SPP[1]:.1f} iterations a "
        f"pass as the batch counts them, "
        f"{med.TRACK_STATS['executed'] / V_MEAN_SPP[1]:.1f} run, "
        f"{med.TRACK_STATS['syncs'] / V_MEAN_SPP[1]:.1f} host syncs a pass")
    vp = job.render(scene, loop_settings(big, "volpath"),
                    spp=V_MEAN_SPP[0]).cpu().numpy()
    check_image("bdpt volume", bd)
    box = projected_box(scene, VOLUME_CENTRES[2], VOLUME_RADIUS,
                        V_MEAN_RES)
    rel = mean_against("bdpt volume", bd, vp, 0.05, box=box)
    log(f"[bdpt volume] {V_MEAN_SPP[1]} passes at {V_MEAN_RES}^2 in "
        f"{bd_s:.2f} s, launches {got['closest']} + {got['anyhit']}; phase "
        f"{time.perf_counter() - t0:.1f} s ({smi})")
    return dict(rel=rel, seconds=bd_s)


# ---------------------------------------------------------------------------
# photon mapping, VPL, irradiance caching, adaptive sampling, multichannel
# ---------------------------------------------------------------------------

PH_RES = 128  # the card vs CPU images and the means against path
PH_PHOTONS = 250000  # photons a pass of the sppm phases (the default)
PH_PARITY_PHOTONS = 20000  # photons a pass of the sppm card vs CPU images
PH_MEAN_SPP = 32  # path passes of the 128^2 means


def intersect_calls(run, keep, fn="intersect_v"):
    """(o, d, tmin, tmax) of the calls ``keep`` (indices) of
    ``isect.<fn>`` during ``run()``, as the integrator hands them over."""
    calls, orig = {}, getattr(isect, fn)
    count = [0]

    def spy(geom, o, d, tmin, tmax, **kw):
        if count[0] in keep:
            calls[count[0]] = (o, d, tmin, tmax)
        count[0] += 1
        return orig(geom, o, d, tmin, tmax, **kw)

    setattr(isect, fn, spy)
    try:
        run()
    finally:
        setattr(isect, fn, orig)
    return [calls[k] for k in keep]


def slice_render(tag, scene, settings, expect):
    """job.render with every count set to 0 first, timed by CUDA events;
    raises unless the launches are ``expect`` (totals, the keys given; the
    others 0).  Returns (image numpy, counts, ms, peak GiB)."""
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    ms = cuda_ms(lambda: out.setdefault("img", job.render(scene, settings)),
                 1, warm=False)
    got = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: expect.get(k, 0) for k in got}
    log(f"[{tag}] render {settings.width}x{settings.height} spp "
        f"{settings.spp} integrator {settings.integrator}: launches "
        + ", ".join(f"{k} {v}" for k, v in got.items() if v or want[k])
        + f"; {ms:.3f} ms (CUDA events); peak device memory {peak:.3f} GiB")
    if got != want:
        raise AssertionError(f"[{tag}] expected launches {want}, got {got}")
    return out["img"].cpu().numpy(), got, ms, peak


def slice_parity(tag, scene, cpu_scene, settings, **props):
    """Card vs CPU at PH_RES^2 under the gate (``props`` override the
    integrator's properties)."""
    st = loop_settings(settings, settings.integrator, PH_RES, **props)
    parity_gate(f"{tag} {PH_RES}^2",
                image_values(scene, st, PH_RES, spp=st.spp),
                image_values(cpu_scene, st, PH_RES, spp=st.spp))


def _on(x, dev):
    """Tensors (in tuples, named tuples and dicts) moved to ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _on(v, dev) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [_on(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def sppm_parity(tag, scene, cpu_scene, settings, res, photons):
    """sppm card vs CPU at res^2: the image under the gate with the card's
    passes given the CPU's photons (``sppm.photon_trace``'s output of the
    CPU run, moved to the card), every other stage the card's own; the
    photon trace held apart (one pass's deposits card vs CPU: the valid
    flags and the positions); the image with the card's own photons
    under the gate's sum only.  A 1-ulp change of the light rays'
    directions alone moves ~1.6% of a 128^2 sppm image's pixels by up to
    ~3% (a CPU run): a photon's last bit decides its count at a radius,
    and the radius update carries the count into the next passes."""
    st = loop_settings(settings, "sppm", res, photon_count=photons)
    orig, seen = sppm.photon_trace, []

    def record(*a, **kw):
        seen.append(orig(*a, **kw))
        return seen[-1]

    sppm.photon_trace = record
    try:
        cpu = image_values(cpu_scene, st, res, spp=st.spp)
    finally:
        sppm.photon_trace = orig
    fed = iter(seen)
    sppm.photon_trace = lambda *a, **kw: _on(next(fed), scene.device)
    try:
        card = image_values(scene, st, res, spp=st.spp)
    finally:
        sppm.photon_trace = orig
    parity_gate(f"{tag} {res}^2, the CPU's photons", card, cpu)
    own = image_values(scene, st, res, spp=st.spp)
    rel = abs(float(own.sum()) - float(cpu.sum())) / float(cpu.sum())
    st_own = parity_stats(own, cpu)
    log(f"[{tag}] {res}^2 with the card's own photons: sum rel {rel:.3e} "
        f"(gate < 5e-3), per pixel " + ", ".join(
            f"{k} {st_own[k]:.3e}" for k in ("p999", "frac_bad", "max_rel")))
    if not rel < 5e-3:
        raise AssertionError(f"[{tag}] card vs CPU image sum")
    md = st.integrator_props.get("max_depth", -1)
    ph = [orig(sc, rng.make_sampler_v(torch.arange(photons, device=sc.device),
                                      0, 0), md if md > 0 else 8,
               want_volume=True) for sc in (scene, cpu_scene)]
    card_v, cpu_v = ph[0][3].cpu(), ph[1][3]
    both = card_v & cpu_v
    dp = torch.stack([(a.cpu() - b).abs() for a, b in zip(ph[0][0],
                                                          ph[1][0])]).amax(0)
    moved = int((both & (dp > 1e-4)).sum())
    flips = int((card_v != cpu_v).sum())
    close = dp[both & (dp <= 1e-4)]
    log(f"[{tag}] one pass's photon deposits card vs CPU: "
        f"{int(cpu_v.sum())} of {cpu_v.numel()} valid, flags unlike {flips},"
        f" moved beyond 1e-4 {moved} (a path whose roulette or edge went "
        f"the other way), the rest within "
        f"{float(close.max()) if close.numel() else 0.0:.3e}")
    if flips + moved > max(int(cpu_v.sum()) * 1e-3, 1):
        raise AssertionError(f"[{tag}] photon deposits card vs CPU")


def irrcache_parity(tag, scene, cpu_scene, settings, res):
    """irrcache card vs CPU at res^2: the image under the gate with the
    card's final pass given the CPU's records (``irrcache.cache_records``
    of the CPU run, moved to the card); the records apart (valid flags
    unlike on at most 0.2%, the share of E and R within rel 1e-3); the
    image with the card's own records under the gate's sum only.  On a
    square image the records of the diagonal's pixel centres lie on the
    box's edge between the floor and the green wall: the last bit of a
    camera ray decides whether it hits, and their hemisphere rays start on
    the wall's plane, where the last bit of a direction decides hit or
    miss for many of their samples."""
    st = loop_settings(settings, "irrcache", res)
    orig, seen = irrcache.cache_records, []

    def record(*a, **kw):
        seen.append(orig(*a, **kw))
        return seen[-1]

    irrcache.cache_records = record
    try:
        cpu = image_values(cpu_scene, st, res, spp=st.spp)
    finally:
        irrcache.cache_records = orig
    irrcache.cache_records = lambda *a, **kw: _on(seen[0], scene.device)
    try:
        card = image_values(scene, st, res, spp=st.spp)
    finally:
        irrcache.cache_records = orig
    parity_gate(f"{tag} {res}^2, the CPU's records", card, cpu)
    own_rec, _ = orig(scene, st, int(st.seed))
    cpu_rec = seen[0][0]
    both = own_rec["valid"].cpu() & cpu_rec["valid"]
    flips = int((own_rec["valid"].cpu() != cpu_rec["valid"]).sum())
    shares = {}
    for k in ("E", "R"):
        a, b = own_rec[k].cpu()[both], cpu_rec[k][both]
        rel = ((a - b).abs() / b.abs().clamp_min(1e-6)).reshape(len(b), -1)
        shares[k] = float((rel.amax(1) <= 1e-3).float().mean())
    own = image_values(scene, st, res, spp=st.spp)
    rel = abs(float(own.sum()) - float(cpu.sum())) / float(cpu.sum())
    st_own = parity_stats(own, cpu)
    log(f"[{tag}] records card vs CPU: {len(cpu_rec['R'])}, valid flags "
        f"unlike {flips} (camera rays through pixel centres on the box's "
        f"edge), of the valid ones within rel 1e-3: E {shares['E']:.4f}, R "
        f"{shares['R']:.4f};"
        f" {res}^2 with the card's own records: sum rel {rel:.3e} (gate < "
        f"5e-3), per pixel " + ", ".join(
            f"{k} {st_own[k]:.3e}" for k in ("p999", "frac_bad", "max_rel")))
    if (not rel < 5e-3 or min(shares.values()) < 0.95
            or flips > max(1, len(cpu_rec["R"]) // 500)):
        raise AssertionError(f"[{tag}] card vs CPU records or image sum")


def mean_vs_path(tag, scene, settings, depth, rtol, **props):
    """The PH_RES^2 mean of the settings' integrator within rtol of the
    card's path tracer at ``depth`` (PH_MEAN_SPP passes)."""
    st = loop_settings(settings, settings.integrator, PH_RES, **props)
    img = job.render(scene, st).cpu().numpy()
    path = job.render(scene, loop_settings(st, "path", depth=depth,
                                           spp=PH_MEAN_SPP)).cpu().numpy()
    return mean_against(tag, img, path, rtol)


def slice_profile(tag, scene, settings, passes):
    """Device operations, device time and idle share a pass of job.render
    at ``passes`` passes (one profiled run after a warm-up run)."""
    p = device_profile(tag, lambda k: job.render(scene, settings,
                                                 spp=passes), passes=1,
                       top=4)
    if p is not None:
        for k in ("ops", "device_ms"):
            p[k] /= passes
        log(f"[{tag}] a pass: {p['ops']:.1f} device operations, "
            f"{p['device_ms']:.3f} ms of device time, idle share "
            f"{p['idle']:.3f}")
    return p


def sppm_cornell_phase(dev, smi):
    """42. [sppm cornell]: sppm on _tiny_cornell at 1024^2, 250,000 photons
    of 8 bounces, 4 passes: 15 closest-hit launches a pass (the camera ray,
    six delta bounces, eight photon bounces), no any hit; both brute-force
    kernels bit for bit on the photons' first two rays; card vs CPU at
    128^2 (2 passes of 20,000 photons, ``sppm_parity``); its 128^2 mean
    within 12% of the card's path."""
    scene, settings = tiny_cornell(dev)
    settings = loop_settings(settings, "sppm", RES, SPP, -1,
                             photon_count=PH_PHOTONS)
    sppm.reset_gather_stats()
    img, got, ms, peak = slice_render("sppm cornell", scene, settings,
                                      dict(closest=15 * SPP))
    g = dict(sppm.GATHER_STATS)
    check_image("sppm cornell", img)
    left, right = left_right(img)
    if not (left[0] > left[1] and right[1] > right[0]):
        raise AssertionError("[sppm cornell] red wall not on the left / "
                             "green not on the right")
    log(f"[sppm cornell] a pass: {ms / SPP:.3f} ms, gather chunks "
        f"{g['chunks'] / SPP:.1f}, pairs {g['pairs'] / SPP:.4e}, kept "
        f"within the radius {g['kept'] / SPP:.4e}")
    prof = slice_profile("sppm cornell", scene, settings, 1)
    # the photons' rays from the lights and their first bounce
    calls = intersect_calls(lambda: job.render(scene, settings, spp=1),
                            [7, 8])
    err = {"closest": 0.0, "anyhit": 0.0}
    for name, (o, d, tmin, tmax) in zip(("light rays", "first bounce"),
                                        calls):
        e = check_tri(f"sppm cornell photon {name}", dict(
            geom=scene.geom, o=o, d=d, forms=[("photon rays", tmin, tmax)]))
        err = {k: max(err[k], e[k]) for k in err}
    cpu_scene, _ = tiny_cornell("cpu")
    sppm_parity("sppm cornell", scene, cpu_scene,
                loop_settings(settings, "sppm", spp=2), PH_RES,
                PH_PARITY_PHOTONS)
    rel = mean_vs_path("sppm cornell", scene, settings, -1, 0.12)
    return dict(pass_ms=ms / SPP, per_pass=(got["closest"] // SPP, 0),
                prof=prof, peak=peak, err=err, rel=rel, gather=g)


def sppm_volume_phase(dev, smi):
    """43. [sppm volume]: sppm on volume_cornell (its homogeneous media
    deposit volume photons; the beam estimate along the camera rays'
    first segments in the fog, whose mixture phase goes through the port's
    phase functions, ROADMAP C16) at 128^2, card vs CPU."""
    scene, settings = volume_cornell(dev)
    cpu_scene, _ = volume_cornell("cpu")
    st = loop_settings(settings, "sppm", PH_RES, 2, DEPTH,
                       photon_count=PH_PARITY_PHOTONS)
    pid = torch.arange(PH_PARITY_PHOTONS, device=dev)
    vol = sppm.photon_trace(scene, rng.make_sampler_v(pid, 0, 0), DEPTH,
                            want_volume=True)[-1]
    n_vol = int(vol[3].sum())
    t0 = time.perf_counter()
    card = image_values(scene, st, PH_RES)
    card_s = time.perf_counter() - t0
    no_media = dataclasses.replace(scene, media=dataclasses.replace(
        scene.media, n_media=0))
    flat = image_values(no_media, st, PH_RES)
    log(f"[sppm volume] {PH_RES}^2 {st.spp} passes of "
        f"{PH_PARITY_PHOTONS} photons in {card_s:.2f} s; a pass's first "
        f"photons leave {n_vol} volume photons; the image mean "
        f"{card.mean():.5f} with media, {flat.mean():.5f} with the media "
        f"off")
    if n_vol < 100 or not np.isfinite(card).all():
        raise AssertionError("[sppm volume] no volume photons, or a "
                             "non-finite image")
    sppm_parity("sppm volume", scene, cpu_scene, st, PH_RES,
                PH_PARITY_PHOTONS)
    return dict(volume_photons=n_vol, seconds=card_s)


def sppm_large_phase(dev, smi):
    """44. [sppm large]: sppm on the 1,120,504-triangle scene (photons from
    the unit environment's bounding disk) at 768^2, depth 3, 2 passes: 10
    hier_closest launches a pass (the camera ray, six delta bounces, three
    photon bounces), no brute-force launch; both hierarchy kernels bit for
    bit on the photons' first two rays; card vs CPU at 64^2."""
    scene, settings = large_scene(dev)
    settings = loop_settings(settings, "sppm", L_RES, L_SPP, L_DEPTH,
                             photon_count=PH_PHOTONS)
    img, got, ms, peak = slice_render("sppm large", scene, settings,
                                      dict(hier_closest=10 * L_SPP))
    lum = check_image("sppm large", img)
    corners = lum[[0, 0, -1, -1], [0, -1, 0, -1]]
    log(f"[sppm large] corners luminance {np.round(corners, 5).tolist()}, "
        f"mean {lum.mean():.5f}")
    if not (np.abs(corners - 1.0) < 1e-3).all():
        raise AssertionError("[sppm large] the corners do not see the unit "
                             "environment")
    prof = slice_profile("sppm large", scene, settings, 1)
    calls = intersect_calls(lambda: job.render(scene, settings, spp=1),
                            [7, 8])
    err = 0.0
    for name, (o, d, tmin, tmax) in zip(("light rays", "first bounce"),
                                        calls):
        e, _, _ = check_hier(f"sppm large photon {name}", scene.clusters,
                             o, d, tmin, tmax)
        err = max(err, e)
    cpu_scene, _ = large_scene("cpu")
    sppm_parity("sppm large", scene, cpu_scene, settings, 64,
                PH_PARITY_PHOTONS)
    return dict(pass_ms=ms / L_SPP, per_pass=(got["hier_closest"] // L_SPP,
                                             0), prof=prof, peak=peak,
                err=err)


def vpl_cornell_phase(dev, smi):
    """45. [vpl cornell]: vpl on _tiny_cornell at 1024^2, 256 light paths,
    depth 5 (768 VPLs a pass), 2 passes: 8 closest-hit launches a pass (the
    camera ray, four delta bounces, three light bounces) and 1 + 768 / 16
    any-hit launches (the next-event ray, 16 VPLs a wavefront); both
    brute-force kernels bit for bit on the first VPL wavefront's shadow
    rays; card vs CPU at 128^2 (one pass); its 128^2 mean within 10% of
    the card's path at depth 5."""
    scene, settings = tiny_cornell(dev)
    # a VPL pass takes four of the settings' samples (render_vpl)
    settings = loop_settings(settings, "vpl", RES, 8, DEPTH, vpl_count=256)
    n_vpl = 256 * (DEPTH - 2)
    batch = vpl.VPL_LANES // (RES * RES)
    n_any = 1 + -(-n_vpl // batch)
    img, got, ms, peak = slice_render(
        "vpl cornell", scene, settings,
        dict(closest=(5 + DEPTH - 2) * 2, anyhit=n_any * 2))
    check_image("vpl cornell", img)
    left, right = left_right(img)
    if not (left[0] > left[1] and right[1] > right[0]):
        raise AssertionError("[vpl cornell] red wall not on the left / "
                             "green not on the right")
    prof = slice_profile("vpl cornell", scene, settings, 1)
    o, d, tmin, tmax = intersect_calls(
        lambda: job.render(scene, settings, spp=1), [1], "occluded_v")[0]
    err = check_tri("vpl cornell VPL shadow rays", dict(
        geom=scene.geom, o=o, d=d,
        forms=[("VPL tmin, per-ray tmax", tmin, tmax)]))
    cpu_scene, _ = tiny_cornell("cpu")
    slice_parity("vpl cornell", scene, cpu_scene, settings, spp=1)
    rel = mean_vs_path("vpl cornell", scene, settings, DEPTH, 0.10)
    return dict(pass_ms=ms / 2, per_pass=(got["closest"] // 2,
                                         got["anyhit"] // 2),
                prof=prof, peak=peak, err=err, rel=rel, vpls=n_vpl)


def irrcache_cornell_phase(dev, smi):
    """46. [irrcache cornell]: irrcache on _tiny_cornell at 1024^2, a
    record every 4 pixels (65,536: 256 long-reach ones dense, the rest in
    the hash grid), 588 hemisphere samples of the nested path at depth 3,
    1 spp: launches, records and the dense/grid split; card vs CPU at
    128^2; its 128^2 mean within 20% of the card's path at depth 6."""
    scene, settings = tiny_cornell(dev)
    settings = loop_settings(settings, "irrcache", RES, 1, None,
                             quality=1.0, resolution=4, irr_samples=588,
                             nested=dict(name="path", max_depth=3))
    m = (RES // 4) ** 2
    batches = -(-588 // (irrcache.IRR_LANES // m))
    img, got, ms, peak = slice_render(
        "irrcache cornell", scene, settings,
        dict(closest=1 + 4 * batches + 1, anyhit=2 * batches + 1))
    gs = dict(irrcache.GRID_STATS)
    log(f"[irrcache cornell] {gs['records']} records: {gs['dense']} dense, "
        f"{gs['grid']} in the grid, {gs['pairs']:.4e} grid pairs; "
        f"{batches} hemisphere wavefronts; the render {ms:.3f} ms")
    check_image("irrcache cornell", img)
    prof = slice_profile("irrcache cornell", scene, settings, 1)
    cpu_scene, _ = tiny_cornell("cpu")
    irrcache_parity("irrcache cornell", scene, cpu_scene, settings, PH_RES)
    rel = mean_vs_path("irrcache cornell", scene, settings, 6, 0.20)
    return dict(pass_ms=ms, launches=(got["closest"], got["anyhit"]),
                prof=prof, peak=peak, rel=rel, grid=gs)


def adaptive_cornell_phase(dev, smi):
    """47. [adaptive cornell]: adaptive on _tiny_cornell at 1024^2, rounds
    of 4 samples, maxError 0.05, at most 32 rounds, the nested path at
    depth 5: the active pixels of each round, launches (5 + 4 a sample);
    card vs CPU at 128^2 (4 rounds); its 128^2 mean within 15% of the
    card's path (8 rounds)."""
    scene, settings = tiny_cornell(dev)
    settings = loop_settings(settings, "adaptive", RES, SPP, None,
                             max_error=0.05, p_value=0.05, max_spp=32,
                             nested=dict(name="path", max_depth=DEPTH))
    rounds = []
    ci.reset_launch_counts()
    ch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    ms = cuda_ms(lambda: out.setdefault("img", adaptive.render_adaptive(
        scene, settings, round_cb=lambda r, pix: rounds.append(len(pix)))),
        1, warm=False)
    got = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(rounds) * SPP
    log(f"[adaptive cornell] {len(rounds)} rounds of {SPP} samples in "
        f"{ms:.3f} ms, active pixels a round: {rounds}; launches "
        f"{got['closest']} + {got['anyhit']}; peak {peak:.3f} GiB")
    if (got["closest"], got["anyhit"]) != (DEPTH * n, (DEPTH - 1) * n):
        raise AssertionError("[adaptive cornell] launches")
    if rounds[0] != RES * RES or rounds != sorted(rounds, reverse=True):
        raise AssertionError("[adaptive cornell] active pixel counts")
    check_image("adaptive cornell", out["img"].cpu().numpy())
    cpu_scene, _ = tiny_cornell("cpu")
    slice_parity("adaptive cornell", scene, cpu_scene, settings, max_spp=4)
    rel = mean_vs_path("adaptive cornell", scene, settings, DEPTH, 0.15,
                       max_spp=8)
    return dict(ms=ms, rounds=rounds, launches=(got["closest"],
                                                got["anyhit"]), peak=peak,
                rel=rel)


def multichannel_phase(dev, smi):
    """48. [multichannel]: path (depth 5) and field shapeIndex from a scene
    file through the command line at 1024^2, 2 spp: the EXR's layers read
    back (R, G, B and field.R/G/B) equal the render's in half precision;
    the path layer is path's own render; card vs CPU at 128^2."""
    xml = with_integrator(CORNELL_XML.format(res=RES, spp=2,
                                             max_depth=DEPTH),
                          '<integrator type="multichannel">'
                          '<integrator type="path"><integer name="maxDepth" '
                          f'value="{DEPTH}"/></integrator>'
                          '<integrator type="field"><string name="field" '
                          'value="shapeIndex"/></integrator></integrator>')
    path = xml_file("multichannel.xml", xml)
    out = os.path.join(XML_DIR, "multichannel.exr")
    t0 = time.perf_counter()
    run_cli(path, "-o", out)
    cli_s = time.perf_counter() - t0
    data, meta = exr.read_exr(out, all_channels=True)
    names = meta["channels"].split(",")
    scene, settings = scene_xml.load_scene(path, device=dev)
    primary = job.render(scene, settings).cpu().numpy()
    want_names, stack = settings.aux_channels
    if sorted(names) != sorted(want_names) or data.shape[-1] != 6:
        raise AssertionError(f"[multichannel] EXR layers {names}")
    half = stack.astype(np.float16).astype(np.float32)
    diff = sum(int((data[..., names.index(c)] != half[..., k]).sum())
               for k, c in enumerate(want_names))
    alone = job.render(scene, loop_settings(settings, "path",
                                            depth=DEPTH)).cpu().numpy()
    log(f"[multichannel] command line {RES}^2 2 spp: {cli_s:.2f} s; layers "
        f"{names}; EXR entries unlike the render's (half) {diff}; path "
        f"layer against path alone: max |diff| "
        f"{float(np.abs(primary - alone).max()):.3e}; shape indices "
        f"{sorted(set(np.unique(stack[..., 3]).tolist()))}")
    if diff or not np.array_equal(primary, stack[..., :3]):
        raise AssertionError("[multichannel] layers differ")
    cpu_scene, cpu_settings = scene_xml.load_scene(path, device="cpu")
    st = loop_settings(settings, "multichannel", PH_RES)
    card = job.render(scene, st)
    card_stack = st.aux_channels[1]
    cst = loop_settings(cpu_settings, "multichannel", PH_RES)
    job.render(cpu_scene, cst)
    parity_gate(f"multichannel path layer {PH_RES}^2",
                card_stack[..., :3].sum(-1), cst.aux_channels[1][..., :3]
                .sum(-1))
    if not np.array_equal(card_stack[..., 3:], cst.aux_channels[1][..., 3:]):
        raise AssertionError("[multichannel] field layer card vs CPU")
    del card
    return dict(seconds=cli_s)


def photon_phases(dev, smi):
    """Phases 42-48."""
    return [phase(dev, smi) for phase in (
        sppm_cornell_phase, sppm_volume_phase, sppm_large_phase,
        vpl_cornell_phase, irrcache_cornell_phase, adaptive_cornell_phase,
        multichannel_phase)]


def kernel_record(name, source, replaces, launches, err, timing, key,
                  grad_launches, device_ms=None, xml_launches=None,
                  volume_launches=None, ptracer_launches=None,
                  bdpt_launches=None, photon_launches=None):
    bnd = timing[key + "_bound"]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=timing[key],
                plain_ms=timing[key + "_plain"], bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=None, device_ms=device_ms,
                grad_launches=grad_launches, xml_launches=xml_launches,
                volume_launches=volume_launches,
                ptracer_launches=ptracer_launches,
                bdpt_launches=bdpt_launches,
                photon_launches=photon_launches)


def light_tracing_phases(dev, smi):
    """Phases 37-41."""
    return [phase(dev, smi) for phase in (
        ptracer_cornell_phase, ptracer_lights_phase, bdpt_cornell_phase,
        bdpt_large_phase, bdpt_volume_phase)]


def _timed(fn):
    """``fn`` that logs its seconds as ``[seconds] name: s``."""
    @functools.wraps(fn)
    def run(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log(f"[seconds] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out
    return run


# every phase logs its seconds, so that the run's time can be traced to its
# phases against the script's limit
for _name in [n for n in globals() if n.endswith("_phase")]:
    globals()[_name] = _timed(globals()[_name])


def main():
    smi = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    timing = kernel_phase(dev)
    launches, fwd_ms = main_path_phase(dev)
    parity_phase(dev)
    grad_launches = cornell_grad_phase(dev, fwd_ms)
    grad_parity_phase(dev)

    t0 = time.perf_counter()
    scene, settings = large_scene(dev)
    log(f"[large] scene built on the host in {time.perf_counter() - t0:.2f} "
        f"s: {scene.geom.n_tris} triangles")
    err_h, err_ha, htiming = hier_phase(dev, scene)
    hlaunches = large_path_phase(scene, settings)
    large_parity_phase(scene)
    hgrad_launches = large_grad_phase(scene, settings)
    del scene

    m_launches, m_ms, m_prof = material_path_phase(dev)
    material_parity_phase(dev)
    sky_scene, s_launches, s_ms, s_peak, s_prof = sky_path_phase(dev)
    sky_parity_phase(sky_scene)
    del sky_scene
    m_grad_ms = material_grad_phase(dev)
    t_launches, t_ms, t_peak, t_prof, t_mib = textured_path_phase(dev)
    textured_parity_phase(dev)
    textured_white_parity_phase(dev)
    tl_launches, tl_ms, tl_peak = textured_large_phase(dev)
    tg_launches, tg_ms, tg_peak, tg_share = texture_grad_phase(dev, t_ms)
    log(f"[summary] textured_cornell pass {t_ms:.3f} ms, launches "
        f"{t_launches}, device ops per pass "
        f"{fmt(t_prof and t_prof['ops'])}, peak {t_peak:.3f} GiB, atlas "
        f"{t_mib:.3f} MiB; textured large pass {tl_ms:.3f} ms, launches "
        f"{tl_launches}, peak {tl_peak:.3f} GiB; atlas fwd+bwd pass "
        f"{tg_ms:.3f} ms, launches {tg_launches}, peak {tg_peak:.3f} GiB, "
        f"scatter share {fmt(tg_share)}")
    s_ops = sampler_phase(dev)
    l_launches, l_ms, l_peak, l_prof, l_costs = lights_path_phase(dev)
    n_sweep = lights_parity_phase(dev)
    ss_launches, ss_ms, ss_peak, ss_prof = sunsky_path_phase(dev)
    lg_launches, lg_rels = lights_grad_phase(dev)
    t0 = time.perf_counter()
    x_launches, x_load, x_ms = xml_cornell_phase(dev, smi)
    xl_launches, xl = xml_large_phase(dev, smi)
    n_xml = xml_plugins_phase(dev)
    log(f"[summary] xml phases {time.perf_counter() - t0:.1f} s: cornell "
        f"load {x_load:.4f} s, pass {x_ms:.3f} ms, launches {x_launches}; "
        f"large PLY {xl['ply']:.3f} s, EXR {xl['exr']:.3f} s, hierarchy "
        f"{xl['hierarchy']:.3f} s, load {xl['load']:.3f} s, pass "
        f"{xl['pass_ms']:.3f} ms, launches {xl_launches}, peak "
        f"{xl['peak_gib']:.3f} GiB; {n_xml} plugin scene files ({smi})")
    log(f"[summary] lights_cornell pass {l_ms:.3f} ms, launches "
        f"{l_launches}, device ops per pass {fmt(l_prof and l_prof['ops'])},"
        f" peak {l_peak:.3f} GiB; in turns " + "; ".join(
            f"{k} {statistics.median(t):.3f} ms {fmt(o)} ops"
            for k, (t, o, _) in l_costs.items())
        + f"; one LDS block {fmt(s_ops['ldsampler'][0])} device ops "
        f"(independent {fmt(s_ops['independent'][0])}); {n_sweep} sweep "
        f"gates passed; sunsky pass {ss_ms:.3f} ms, launches {ss_launches},"
        f" device ops per pass {fmt(ss_prof and ss_prof['ops'])}, peak "
        f"{ss_peak:.3f} GiB; lights grad launches {lg_launches}, card vs "
        f"CPU max rel " + ", ".join(f"{k} {v:.3e}"
                                    for k, v in lg_rels.items()))
    log(f"[summary] material_cornell pass {m_ms:.3f} ms, launches "
        f"{m_launches}, device ops per pass "
        f"{fmt(m_prof and m_prof['ops'])}; sky scene pass {s_ms:.3f} ms, "
        f"launches {s_launches}, peak {s_peak:.3f} GiB, device ops per pass "
        f"{fmt(s_prof and s_prof['ops'])}; material fwd+bwd pass at "
        f"{M_GRAD_RES}^2 {m_grad_ms:.3f} ms")

    t0 = time.perf_counter()
    ml = motion_large_phase(dev)
    mc = motion_cornell_phase(dev)
    inst = instanced_phase(dev)
    irw = irawan_phase(dev)
    ints = integrators_phase(dev, smi)
    tl = tiled_phase(dev, smi)
    mt = ml["timing"]
    log(f"[summary] phases 29-34 {time.perf_counter() - t0:.1f} s: motion "
        f"large pass {ml['pass_ms']:.3f} ms, peak {ml['peak']:.3f} GiB, "
        f"motion mode ms closest {fmt(mt['motion_closest'])} (static "
        f"{fmt(mt['static_closest'])}), anyhit {fmt(mt['motion_anyhit'])} "
        f"(static {fmt(mt['static_anyhit'])}), device ms closest "
        f"{fmt(mt['motion_closest_device'])} (static "
        f"{fmt(mt['static_closest_device'])}), anyhit "
        f"{fmt(mt['motion_anyhit_device'])} (static "
        f"{fmt(mt['static_anyhit_device'])}); motion cornell pass "
        f"{mc['pass_ms']:.3f} ms; instanced pass {inst['pass_ms']:.3f} ms, "
        f"peak {inst['peak']:.3f} GiB; irawan pass {irw['pass_ms']:.3f} ms, "
        f"device ops per pass {fmt(irw['prof'] and irw['prof']['ops'])}; "
        f"tiled 4096^2 peak {tl['tiled_peak']:.3f} GiB vs full frame "
        f"{tl['full_peak']:.3f} GiB; integrators " + ", ".join(
            f"{k} {v['pass_ms']:.3f} ms" for k, v in ints.items())
        + f" ({smi})")

    t0 = time.perf_counter()
    vc = volume_cornell_phase(dev, smi)
    vl = volume_large_phase(dev, smi)
    log(f"[summary] phases 35-36 {time.perf_counter() - t0:.1f} s: " + "; ".join(
        f"{k} pass {v['pass_ms']:.3f} ms (turns "
        f"{', '.join(f'{t:.3f}' for t in v['turns'])}), launches a pass "
        f"{v['launches_per_pass']}, tracking iterations {v['iters']:.1f} "
        f"({v['ran']:.1f} run) and host syncs {v['syncs']:.1f} a pass, "
        f"device ops per pass "
        f"{fmt(v['prof'] and v['prof']['ops'])}, device ms per pass "
        f"{fmt(v['prof'] and v['prof']['device_ms'])}, idle "
        f"{fmt(v['prof'] and v['prof']['idle'])}, peak {v['peak']:.3f} GiB"
        for k, v in (("volume cornell", vc), ("volume large", vl)))
        + f" ({smi})")

    t0 = time.perf_counter()
    pc, _, bc, bl, bv = light_tracing_phases(dev, smi)
    log(f"[summary] phases 37-41 {time.perf_counter() - t0:.1f} s: " + "; ".join(
        f"{k} pass {v['pass_ms']:.3f} ms (turns "
        f"{', '.join(f'{t:.3f}' for t in v['turns'])}), launches a pass "
        f"{v['per_pass']}, device ops per pass "
        f"{fmt(v['prof'] and v['prof']['ops'])}, device ms per pass "
        f"{fmt(v['prof'] and v['prof']['device_ms'])}, idle "
        f"{fmt(v['prof'] and v['prof']['idle'])}, peak {v['peak']:.3f} GiB"
        for k, v in (("ptracer cornell", pc), ("bdpt cornell", bc),
                     ("bdpt large", bl)))
        + f"; bdpt volume mean rel to volpath {bv['rel']} ({smi})")

    t0 = time.perf_counter()
    sc, sv, sl, vc2, ic, ad, mc2 = photon_phases(dev, smi)
    log(f"[summary] phases 42-48 {time.perf_counter() - t0:.1f} s: " + "; ".join(
        f"{k} pass {v['pass_ms']:.3f} ms, launches a pass {v['per_pass']}, "
        f"device ops per pass {fmt(v['prof'] and v['prof']['ops'])}, device "
        f"ms per pass {fmt(v['prof'] and v['prof']['device_ms'])}, idle "
        f"{fmt(v['prof'] and v['prof']['idle'])}, peak {v['peak']:.3f} GiB"
        for k, v in (("sppm cornell", sc), ("sppm large", sl),
                     ("vpl cornell", vc2)))
        + f"; irrcache {ic['pass_ms']:.3f} ms, launches {ic['launches']}, "
        f"device ops {fmt(ic['prof'] and ic['prof']['ops'])}, records "
        f"{ic['grid']['records']} ({ic['grid']['dense']} dense, "
        f"{ic['grid']['grid']} in the grid), peak {ic['peak']:.3f} GiB; "
        f"adaptive {ad['ms']:.3f} ms, {len(ad['rounds'])} rounds, launches "
        f"{ad['launches']}, peak {ad['peak']:.3f} GiB; sppm volume "
        f"{sv['volume_photons']} volume photons; multichannel command line "
        f"{mc2['seconds']:.2f} s ({smi})")

    kernels = [
        kernel_record("tri_closest", TRI_SOURCE,
                      "mitsuba_im_tpu/accel/pallas_intersect.py:79",
                      launches[0], max(timing["closest_err"], vc["err"],
                                       pc["err"]["closest"],
                                       bc["err"]["closest"],
                                       sc["err"]["closest"],
                                       vc2["err"]["closest"]),
                      timing, "closest", grad_launches[0],
                      timing["closest_device"], x_launches[0],
                      vc["launches_per_pass"], pc["per_pass"][0],
                      bc["per_pass"][0],
                      dict(sppm=sc["per_pass"][0], vpl=vc2["per_pass"][0],
                           irrcache=ic["launches"][0])),
        kernel_record("tri_anyhit", TRI_SOURCE,
                      "mitsuba_im_tpu/accel/pallas_intersect.py:130",
                      launches[1], max(timing["anyhit_err"],
                                       pc["err"]["anyhit"],
                                       bc["err"]["anyhit"],
                                       sc["err"]["anyhit"],
                                       vc2["err"]["anyhit"]),
                      timing, "anyhit", grad_launches[1],
                      timing["anyhit_device"], x_launches[1], None,
                      pc["per_pass"][1], bc["per_pass"][1],
                      dict(sppm=0, vpl=vc2["per_pass"][1],
                           irrcache=ic["launches"][1])),
        kernel_record("hier_closest", HIER_SOURCE, HIER_REPLACES,
                      hlaunches[0], max(err_h, vl["err"], bl["err"],
                                        sl["err"]), htiming,
                      "closest", hgrad_launches[0], htiming["closest_device"],
                      xl_launches[0], vl["launches_per_pass"], None,
                      bl["per_pass"][0], dict(sppm=sl["per_pass"][0])),
        kernel_record("hier_anyhit", HIER_SOURCE, HIER_REPLACES,
                      hlaunches[1], err_ha, htiming, "anyhit",
                      hgrad_launches[1], htiming["anyhit_device"],
                      xl_launches[1], None, None, bl["per_pass"][1],
                      dict(sppm=0)),
        kernel_record("hier_closest_motion", HIER_SOURCE,
                      HIER_MOTION_REPLACES, ml["launches"][0], ml["err"], mt,
                      "motion_closest", None, mt["motion_closest_device"]),
        kernel_record("hier_anyhit_motion", HIER_SOURCE,
                      HIER_MOTION_REPLACES, ml["launches"][1],
                      float(ml["flips"] > 0), mt, "motion_anyhit", None,
                      mt["motion_anyhit_device"]),
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
