#!/usr/bin/env python3
"""Builds of the hierarchy traversal kernel timed against each other in
turns on the card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 bench_hier_kernels.py [--parent DIR]

"landed" is ``csrc/hier_traverse.cu`` called through the port's wrappers
(``cuda_hierarchy.hier_closest`` / ``hier_anyhit``), as the main path
calls it.  ``--parent DIR`` adds the ``hier_traverse.cu`` of an older
checkout unpacked at DIR (for example ``git archive <commit> | tar -x -C
DIR``), built with the port's flags and bound by the version its library
reports (``hier_interface``): the port's own, interface 2 (the static
entry points of the port's, without the motion mode), or interface 1, the
entry points from before that query existed (no culling boxes, no ray
counters); any other version is refused.

On the 1,120,504-triangle large scene (``scenes.large_scene``) it checks
every build against the plain version bit for bit on the 768^2 camera
rays, their shadow rays (any hit, active = found) and chip_smoke.py's
strung and scattered soups.  Then, at the main path's shapes (closest hit
on the camera rays, any hit on the shadow rays), it times the builds in
turns: the card time of one call with ``chip_smoke.median_ms_in_turns``
(CUDA events around each call, median of ``--reps`` rounds), the kernel's
own device time with ``chip_smoke.device_ms_in_turns`` (torch.profiler,
one primed session per round, median of ``--reps``, and its quartiles over
the rounds, the spread a build's median is read against), and the host's time
to queue one call (median over rounds of 20 calls queued while the card
sleeps, so no call waits for the card).  A build that does
not compile is reported and left out; one that disagrees is timed and
marked (``"exact": false``).  It also prints the bounds of chip_smoke.py
and the landed kernel's sweep work (``chip_smoke.list_work``).  The last
line is a JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from mitsuba_im_tpu_torch.accel import cuda_hierarchy as ch
from mitsuba_im_tpu_torch.accel import hierarchy as hy
from mitsuba_im_tpu_torch.accel.cuda_intersect import _check, _ptrs
from mitsuba_im_tpu_torch.accel.shared_lib import SharedLibrary, nvcc
from mitsuba_im_tpu_torch.core.types import EPSILON, Float, Int
from mitsuba_im_tpu_torch.scenes import large_scene

HOST_CALLS = 20  # calls queued per host-time round
HIER_KERNELS = ("hier_kernel",)  # the traversal kernel's name in a trace
SLEEP_CYCLES = 200_000_000  # ~0.1 s of card sleep: longer than the queueing


def _bind_any(lib):
    """Bind the port's interface, interface 2 (its static entry points) or
    interface 1 (no ``hier_interface``)."""
    if hasattr(lib, "hier_interface"):
        if lib.hier_interface() == 2:
            ch.bind_static(lib)
        else:
            ch._bind(lib)
        return
    p, i = ctypes.c_void_p, ctypes.c_int
    args = [p] * 9 + [i] + [p, p, i, i] + [p] * 6 + [i, i]
    lib.hier_closest.argtypes = args + [p] * 6 + [p]
    lib.hier_closest.restype = i
    lib.hier_anyhit.argtypes = args + [p] + [p]
    lib.hier_anyhit.restype = i


def _outs(n, dev, any_hit):
    if any_hit:
        return (torch.empty(n, dtype=torch.bool, device=dev),)
    return tuple(torch.empty(n, dtype=dt, device=dev) for dt in (
        Float, Float, Float, Int, Int, torch.bool))


def launcher(lib, any_hit):
    """fn(h, o, d, tmin, tmax, active) launching a loaded library's entry
    point without counting, as the port's wrapper of its interface does."""
    name = "hier_anyhit" if any_hit else "hier_closest"
    entry = getattr(lib, name)
    v1 = not hasattr(lib, "hier_interface")

    def fn(h, o, d, tmin, tmax, active=None):
        args, keep, n, dev = ch._kernel_args(h, o, d, tmin, tmax, active)
        outs = _outs(n, dev, any_hit)
        if v1:  # without the culling boxes (after root) and the counters
            stream = torch.cuda.current_stream(dev).cuda_stream
            with torch.cuda.device(dev):
                err = entry(*args[:20], *args[21:], *_ptrs(outs), stream)
            _check(err, name)
        else:
            ch._launch(entry, args, outs, dev)
        return outs[0] if any_hit else outs
    return fn


def builds(args):
    """{name: (library, closest fn, anyhit fn)}; the fns take the loaded
    library."""
    out = {"landed": (ch.LIBRARY, lambda lib: ch.hier_closest,
                      lambda lib: ch.hier_anyhit)}
    if args.parent:
        src = Path(args.parent).resolve() / ch.LIBRARY.source.relative_to(
            ch.LIBRARY.source.parents[2])
        out["parent"] = (SharedLibrary(str(src), nvcc, ch.BUILD_FLAGS,
                                       _bind_any),
                         lambda lib: launcher(lib, False),
                         lambda lib: launcher(lib, True))
    return out


def host_us_in_turns(fns, reps):
    """{name: median µs the host takes to queue one call}: rounds of
    HOST_CALLS calls queued behind a card sleep, the functions in turns."""
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda._sleep(SLEEP_CYCLES)
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            times[k].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout of an older version")
    ap.add_argument("--reps", type=int, default=11)
    args = ap.parse_args()

    smi = cs.device_phase()
    dev = torch.device("cuda", 0)
    cands = builds(args)
    with ThreadPoolExecutor(len(cands)) as pool:
        futs = {k: pool.submit(v[0].load) for k, v in cands.items()}
    report, fns_of = {}, {}
    for k, f in futs.items():
        lib = cands[k][0]
        regs = [ln.strip() for ln in lib.log.splitlines()
                if "registers" in ln or "spill" in ln]
        report[k] = dict(regs=regs, ok=f.exception() is None)
        if f.exception() is not None:
            cs.log(f"[bench] {k}: build failed: {f.exception()}")
            continue
        loaded = f.result()
        report[k]["interface"] = (loaded.hier_interface()
                                  if hasattr(loaded, "hier_interface") else 1)
        fns_of[k] = (cands[k][1](loaded), cands[k][2](loaded))
        for ln in regs:
            cs.log(f"[bench] {k}: {ln}")

    scene, _ = large_scene(dev)
    h = scene.clusters
    gen = torch.Generator(device=dev).manual_seed(4321)
    _, o, d = cs.camera_rays(scene, cs.L_RES)
    t, *_, found = hy.intersect_hierarchy_plain(h, o, d, EPSILON, 1e30)[0]
    p, w, tmax = cs.shadow_rays(scene, o, d, t, found, gen)
    cases = {"camera": (h, o, d, EPSILON, 1e30, None),
             "shadow": (h, p, w, EPSILON, tmax, found)}
    for name, make in (("strung", cs.strung_soups),
                       ("scattered", cs.scattered_soups)):
        hs, o_s, d_s, tmax_s = make(dev, 1 << 16, gen)
        cases[name] = (hs, o_s, d_s, EPSILON, tmax_s, None)
    plain = {k: (hy.intersect_hierarchy_plain(*c[:5], active=c[5])[0],
                 hy.intersect_hierarchy_plain(*c[:5], any_hit=True,
                                              active=c[5])[0].found)
             for k, c in cases.items()}
    for k, (closest, anyhit) in list(fns_of.items()):
        bad = []
        for cname, c in cases.items():
            try:
                kc = closest(*c[:5], active=c[5])
                kb = anyhit(*c[:5], active=c[5])
            except RuntimeError as e:  # a launch the card refused
                cs.log(f"[bench] {k}: {e}")
                report[k]["ok"] = False
                del fns_of[k]
                break
            if not (all(torch.equal(a, b) for a, b in zip(kc, plain[cname][0]))
                    and torch.equal(kb, plain[cname][1])):
                bad.append(cname)
        if k not in fns_of:
            continue
        report[k]["exact"] = not bad
        cs.log(f"[bench] {k}: bit for bit with the plain version on "
               f"{', '.join(cases)}: {'yes' if not bad else f'NO ({bad})'}")

    fns = {}
    cam, sh = cases["camera"], cases["shadow"]
    for k, (closest, anyhit) in fns_of.items():
        fns[f"{k}/closest"] = lambda f=closest: f(*cam[:5], active=cam[5])
        fns[f"{k}/anyhit"] = lambda f=anyhit: f(*sh[:5], active=sh[5])
    rounds = {}
    for unit, got in (("ms", cs.median_ms_in_turns(fns, args.reps)),
                      ("device_ms", cs.device_ms_in_turns(
                          fns, args.reps, names=HIER_KERNELS,
                          rounds=rounds)),
                      ("host_us", host_us_in_turns(fns, args.reps))):
        for key, v in got.items():
            k, which = key.split("/")
            report[k][f"{which}_{unit}"] = v
    for key, v in rounds.items():
        # the spread of a build's device ms: its kept rounds' quartiles
        k, which = key.split("/")
        if len(v) >= 2:
            q = statistics.quantiles(v, n=4)
            report[k][f"{which}_device_ms_quartiles"] = (q[0], q[2])
            cs.log(f"[bench] {key}: device ms rounds {len(v)}, quartiles "
                   f"{q[0]:.4f} - {q[2]:.4f}, range {min(v):.4f} - "
                   f"{max(v):.4f}")
    cam_counts = hy.intersect_hierarchy_plain(*cam[:5])[1]
    sh_counts = hy.intersect_hierarchy_plain(*sh[:5], any_hit=True,
                                             active=sh[5])[1]
    n = cs.L_RES * cs.L_RES
    tables = cs.hier_table_bytes(h)
    bounds = {"closest": cs.bound(n * (32 + 21) + tables,
                                  cs.hier_flops(h, cam_counts)),
              "anyhit": cs.bound(n * (32 + 1 + 1) + tables,
                                 cs.hier_flops(h, sh_counts))}
    work = {}
    for name, cnt, c in (("camera", cam_counts, cam), ("shadow", sh_counts,
                                                        sh)):
        tested, full, over, mean_list = cs.list_work(h, *c[1:5], cnt)
        work[name] = dict(supers_tested=tested, full_sweeps_only=full,
                          overflows=over, mean_list=mean_list)
    nan = float("nan")
    for k, r in report.items():
        cs.log(f"[bench] {k}: closest {r.get('closest_ms', nan):.4f} ms "
               f"(device {cs.fmt(r.get('closest_device_ms'))}, host "
               f"{r.get('closest_host_us', nan):.1f} us), any hit "
               f"{r.get('anyhit_ms', nan):.4f} ms (device "
               f"{cs.fmt(r.get('anyhit_device_ms'))}, host "
               f"{r.get('anyhit_host_us', nan):.1f} us), bit for bit "
               f"{r.get('exact', False)}")
    cs.log(f"[bench] bounds {bounds}; work {work}")
    cs.log(smi)
    rec = dict(device=smi, n_supers=h.n_supers, builds=report,
               bounds=bounds, work=work)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
