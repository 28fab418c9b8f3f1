#!/usr/bin/env python3
"""Builds of the brute-force triangle kernels timed against each other in
turns on the card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 bench_tri_kernels.py [--parent DIR] [--reps N]

"landed" is ``csrc/tri_intersect.cu`` called through the port's wrappers
(``cuda_intersect.closest_tris_v``, ``closest_hit_v``, ``anyhit_tris_v``),
as the main path calls it.  ``--parent DIR`` adds the ``tri_intersect.cu``
of an older checkout unpacked at DIR (for example ``git archive <commit> |
tar -x -C DIR``), bound by the version its library reports
(``tri_interface``): the port's own, or interface 1, the entry points from
before that query existed, called as that version's wrapper called them
(numbers filled into (N,) tensors, five outputs allocated per call, the
device made current); any other version is refused.

Cases: "cornell", the 2^20 camera rays of ``chip_smoke.camera_rays`` at
1024^2 into the 12-triangle Cornell soup, and "random512", 2^20 random
rays into a random 512-triangle soup (``chip_smoke.random_soup``).  Every
build is checked against the plain versions bit for bit on both, with
numbers and with tensors for tmin/tmax (``chip_smoke.tri_forms``): the
closest hit, the hit record (interface 2) and the any hit.  A build that
does not compile is reported and left out; one that disagrees is timed and
marked (``"exact": false``).  Then, for each case and query (closest:
tmin 1e-4, tmax 1e30; record: the same with the hit record; anyhit: tmin
1e-4 and an (N,) tmax, the main path's forms), the builds in turns: (a)
the kernel's own device time
(``chip_smoke.device_ms_in_turns``, torch.profiler, median of ``--reps``
calls), (b) the host's time to queue one call while the card sleeps
(``bench_hier_kernels.host_us_in_turns``), (c) CUDA events around each call
(``chip_smoke.median_ms_in_turns``).  It prints the bounds of
chip_smoke.py, each kernel's SASS instruction counts (``cuobjdump -sass``:
per pair, by the stage a pair reaches) and the modelled issue floors over
each case's pairs (``tri_sass.py``).  The last line is a JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
import tri_sass
from bench_hier_kernels import host_us_in_turns
from mitsuba_im_tpu_torch.accel import cuda_intersect as ci
from mitsuba_im_tpu_torch.accel.shared_lib import SharedLibrary, nvcc
from mitsuba_im_tpu_torch.core.types import Float, Int


def _bind_any(lib):
    """Bind the port's interface, or interface 1 (no ``tri_interface``)."""
    if hasattr(lib, "tri_interface"):
        ci._bind(lib)
        return
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tri_closest.argtypes = [p] * 11 + [i, i] + [p] * 5 + [p]
    lib.tri_closest.restype = i
    lib.tri_anyhit.argtypes = [p] * 11 + [i, i] + [p] + [p]
    lib.tri_anyhit.restype = i


def v1_fns(lib):
    """(closest, anyhit) of interface 1, each a copy of that version's
    wrapper without its launch counter."""
    def inputs(p0, e1, e2, o, d, tmin, tmax):
        comps, n, dev = ci._rays(o, d, tmin, tmax)
        T = ci._tris(p0, e1, e2, dev)
        return ([c.contiguous() for c in comps],
                [a.contiguous() for a in (p0, e1, e2)], n, T, dev)

    def launch(entry, comps, tris, n, T, outs, dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = entry(*ci._ptrs(comps), *ci._ptrs(tris), n, T,
                        *ci._ptrs(outs), stream)
        ci._check(err, entry.__name__)

    def closest(p0, e1, e2, o, d, tmin, tmax):
        comps, tris, n, T, dev = inputs(p0, e1, e2, o, d, tmin, tmax)
        outs = [torch.empty(n, dtype=dt, device=dev)
                for dt in (Float, Float, Float, Int, torch.bool)]
        if n:
            launch(lib.tri_closest, comps, tris, n, T, outs, dev)
        return tuple(outs)

    def anyhit(p0, e1, e2, o, d, tmin, tmax):
        comps, tris, n, T, dev = inputs(p0, e1, e2, o, d, tmin, tmax)
        blocked = torch.empty(n, dtype=torch.bool, device=dev)
        if n:
            launch(lib.tri_anyhit, comps, tris, n, T, [blocked], dev)
        return blocked
    return closest, anyhit


def fns_of(name, lib):
    """{query: fn} of a loaded build: closest(tris, o, d, tmin, tmax),
    record(tris, shape, o, d, tmin, tmax) (interface 2 only) and
    anyhit(tris, o, d, tmin, tmax)."""
    if name == "landed":
        return dict(closest=ci.closest_tris_v, record=ci.closest_hit_v,
                    anyhit=ci.anyhit_tris_v)
    if not hasattr(lib, "tri_interface"):
        closest, anyhit = v1_fns(lib)
        return dict(closest=closest, anyhit=anyhit)
    return dict(
        closest=lambda p0, e1, e2, *a: ci._closest(lib, p0, e1, e2, None,
                                                   *a),
        record=lambda p0, e1, e2, sh, *a: ci._closest(lib, p0, e1, e2, sh,
                                                      *a),
        anyhit=lambda *a: ci._anyhit(lib, *a))


def builds(args):
    """{name: SharedLibrary}."""
    out = {"landed": ci.LIBRARY}
    rel = ci.LIBRARY.source.relative_to(ci.LIBRARY.source.parents[2])
    if args.parent:
        out["parent"] = SharedLibrary(str(Path(args.parent).resolve() / rel),
                                      nvcc, ci.BUILD_FLAGS, _bind_any)
    return out


def check(fns, case):
    """Names of the checks in which ``fns`` differ from the plain
    versions (empty: bit for bit)."""
    geom, o, d, forms = case["geom"], case["o"], case["d"], case["forms"]
    tris = (geom.tri_p0, geom.tri_e1, geom.tri_e2)
    bad = []
    for form, tmin, tmax in forms:
        p = ci.closest_tris_plain(*tris, o, d, tmin, tmax)
        got = {"closest": (fns["closest"](*tris, o, d, tmin, tmax), p),
               "anyhit": ((fns["anyhit"](*tris, o, d, tmin, tmax),),
                          (ci.anyhit_tris_plain(*tris, o, d, tmin, tmax),))}
        if "record" in fns:
            got["record"] = (fns["record"](*tris, geom.tri_shape, o, d, tmin,
                                           tmax),
                             ci.hit_record_plain(geom.tri_shape, *p))
        for q, (k, ref) in got.items():
            if cs.mismatches(k, ref):
                bad.append(f"{q}/{form}")
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout of an older version")
    ap.add_argument("--reps", type=int, default=21)
    args = ap.parse_args()

    smi = cs.device_phase()
    dev = torch.device("cuda", 0)
    cands = builds(args)
    with ThreadPoolExecutor(len(cands)) as pool:
        futs = {k: pool.submit(v.load) for k, v in cands.items()}
    report, fns = {}, {}
    for k, f in futs.items():
        lib = cands[k]
        regs = [ln.strip() for ln in lib.log.splitlines()
                if "registers" in ln or "spill" in ln]
        report[k] = dict(regs=regs, ok=f.exception() is None)
        if f.exception() is not None:
            cs.log(f"[bench] {k}: build failed: {f.exception()}")
            continue
        loaded = f.result()
        report[k]["interface"] = (loaded.tri_interface()
                                  if hasattr(loaded, "tri_interface") else 1)
        fns[k] = fns_of(k, loaded)
        for ln in regs:
            cs.log(f"[bench] {k}: {ln}")
        report[k]["pair_costs"] = tri_sass.kernel_costs(
            tri_sass.sass_text(lib.path()))
        cs.log(f"[bench] {k}: SASS instructions per pair by stage reached "
               f"(det, u, v, all): {report[k]['pair_costs']}")

    cases = cs.tri_cases(dev)
    for k, f in list(fns.items()):
        bad = []
        for cname, case in cases.items():
            try:
                bad += [f"{cname}/{b}" for b in check(f, case)]
            except RuntimeError as e:  # a launch the card refused
                cs.log(f"[bench] {k}: {e}")
                report[k]["ok"] = False
                del fns[k]
                break
        if k not in fns:
            continue
        report[k]["exact"] = not bad
        cs.log(f"[bench] {k}: bit for bit with the plain versions on "
               f"{', '.join(cases)}: {'yes' if not bad else f'NO ({bad})'}")

    times = {}
    for cname, case in cases.items():
        geom, o, d = case["geom"], case["o"], case["d"]
        tris = (geom.tri_p0, geom.tri_e1, geom.tri_e2)
        calls = {}
        for k, f in fns.items():
            calls[f"{k}/closest"] = lambda f=f: f["closest"](
                *tris, o, d, 1e-4, 1e30)
            if "record" in f:
                calls[f"{k}/record"] = lambda f=f: f["record"](
                    *tris, geom.tri_shape, o, d, 1e-4, 1e30)
            calls[f"{k}/anyhit"] = lambda f=f: f["anyhit"](
                *tris, o, d, 1e-4, case["tmax"])
        got = {"device_ms": cs.device_ms_in_turns(calls, args.reps),
               "event_ms": cs.median_ms_in_turns(calls, args.reps),
               "host_us": host_us_in_turns(calls, args.reps)}
        for key in calls:
            times[f"{cname}/{key}"] = {m: v[key] for m, v in got.items()}
            t = times[f"{cname}/{key}"]
            cs.log(f"[bench] {cname} {key}: device {cs.fmt(t['device_ms'])}"
                   f" ms, events {t['event_ms']:.4f} ms, host "
                   f"{t['host_us']:.1f} us")

    bounds, floors = {}, {}
    for cname, case in cases.items():
        geom, o, d = case["geom"], case["o"], case["d"]
        tris = (geom.tri_p0, geom.tri_e1, geom.tri_e2)
        bounds[cname] = cs.tri_bounds(cs.N_RAYS, tris[0].shape[0])
        for k in fns:
            floors[f"{cname}/{k}"] = {
                q: tri_sass.issue_floor_ms(
                    tris, o, d, 1e-4, case["tmax"] if q == "anyhit" else 1e30,
                    c, q == "anyhit")
                for q, c in report[k]["pair_costs"].items()}
        cs.log(f"[bench] {cname}: bounds {bounds[cname]}; issue floors "
               + "; ".join(f"{k}: {v}" for k, v in floors.items()
                           if k.startswith(cname)))
    cs.log(smi)
    print(json.dumps(dict(device=smi, builds=report, times=times,
                          bounds=bounds, issue_floors=floors)), flush=True)


if __name__ == "__main__":
    main()
