"""Batch render command line (``mitsuba_im_tpu/cli/main.py``, the
``mitsuba`` executable's flags, ``mitsuba.cpp:51-88``).

    python -m mitsuba_im_tpu_torch scene.xml -D spp=4 -o out.exr

Each scene file is loaded (``scene/xml.py``), built on ``--device`` (the
card by default; without one the command raises, and ``--device cpu``
runs the kernels' plain versions) and rendered in the reference's order
of dispatch (its ``cli/main.py:146-163``): with ``--nodes`` across render
nodes (``parallel/remote.py``: ``host[:port]`` or ``exec:CMD`` nodes
separated by ``;``, e.g. ``exec:python -m mitsuba_im_tpu_torch.cli.mtssrv
-ls``, and this process unless ``--no-local-worker``); by ``render``
through the render loop of ``ptracer``, ``bdpt``,
``sppm``/``ppm``/``photonmapper``, ``vpl``, ``adaptive``,
``multichannel``, ``irrcache``, ``pssmlt``, ``mlt`` or ``erpt`` (which,
as the reference's, take no ``-c``/``-z``/``-r``/``-S``; a multichannel
EXR holds every child's layer; ``-s`` counts pssmlt's and mlt's mutations
and erpt's seeds a pixel); with ``-m`` sharded over a ``torch.distributed``
group (``parallel/mesh.py``: under torchrun's ``RANK``/``WORLD_SIZE``
every rank renders its share of the pixels and rank 0 writes the output;
without them a world of one); a ``tiledhdrfilm`` scene with an EXR output
band by band into an out-of-core film (``film/tiled.py``, at its default
band height, as the reference's command line); else by ``render_film``
with the scene's integrator (``path``, ``volpath``, ``direct``, ``ao``,
``field`` or ``motion``).  The image is written as EXR, or as a
tone-mapped PNG/PPM by the output's extension.  ``--nodes``, ``-m`` and
the tiled film take no ``-c``/``-z``/``-r``/``-S``, as in the reference.
Flags: ``-D key=value`` substitution, ``-o`` output, ``-s`` samples per
pixel, ``-r`` a partial image every N seconds, ``-S`` a numbered image
every N samples per pixel, ``-x`` skip a scene whose output exists,
``-c`` a checkpoint after each pass, ``-z`` resume from one, ``-j`` load
the next scenes on host threads while the device renders, ``-q``/``-v``,
``--width``/``--height``.  As the reference's, the command line has no
``-i``: the interactive shell is ``python -m
mitsuba_im_tpu_torch.interactive scene.xml``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mitsuba_im_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scenes", nargs="+", help="scene XML file(s)")
    ap.add_argument("-D", dest="defines", action="append", default=[],
                    metavar="key=value", help="scene parameter substitution")
    ap.add_argument("-o", dest="output", default=None,
                    help="output file (default: scene name + .exr)")
    ap.add_argument("-s", dest="spp", type=int, default=None,
                    help="override spp")
    ap.add_argument("-r", dest="flush_sec", type=float, default=0,
                    help="write partial image every N seconds")
    ap.add_argument("-S", dest="progressive", type=int, default=0,
                    metavar="N", help="write a numbered image every N spp")
    ap.add_argument("-x", dest="skip_existing", action="store_true",
                    help="skip scenes whose output already exists")
    ap.add_argument("-c", dest="checkpoint", default=None,
                    help="write a resume checkpoint after each pass")
    ap.add_argument("-z", dest="resume", default=None,
                    help="resume from a checkpoint file")
    ap.add_argument("-j", dest="jobs", type=int, default=1,
                    help="load the next scenes on host threads while the "
                         "device renders")
    ap.add_argument("-q", dest="quiet", action="store_true")
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("-m", dest="multichip", action="store_true",
                    help="shard the render over a torch.distributed group "
                         "(torchrun's environment, else a world of one)")
    ap.add_argument("--nodes", dest="nodes", default=None,
                    help="semicolon-separated render nodes: host[:port] or "
                         "'exec:CMD' (e.g. exec:ssh host python -m "
                         "mitsuba_im_tpu_torch.cli.mtssrv -ls)")
    ap.add_argument("--local-worker", dest="local_worker",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="with --nodes: also render in this process")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    params = {}
    for d in args.defines:
        if "=" not in d:
            raise SystemExit(f"bad -D argument '{d}' (expected key=value)")
        k, v = d.split("=", 1)
        params[k] = v

    from ..core.types import entry_device

    mesh = None
    joined = False
    if args.multichip and not args.nodes:
        import torch.distributed as dist

        from ..parallel.mesh import init_distributed

        joined = not dist.is_initialized()
        mesh = init_distributed(device=args.device)
        joined = joined and mesh.group is not None
        device = mesh.device
    else:
        device = entry_device(args.device)
    say = (lambda *a: None) if args.quiet or (mesh and mesh.rank) else (
        lambda *a: print(*a, flush=True))
    try:
        _render_scenes(args, params, device, mesh, say)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


def _render_scenes(args, params, device, mesh, say) -> None:
    """Load, render and write each scene file; under ``-m`` every rank
    renders and rank 0 alone writes."""
    from ..film.film import develop
    from ..render.job import LOOP_INTEGRATORS, render, render_film
    from ..render.job import save_render as _save
    from ..scene.xml import load_scene

    def save_render(*a, **kw):
        if mesh is None or mesh.rank == 0:
            _save(*a, **kw)

    pending = None
    if args.jobs > 1 and len(args.scenes) > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=args.jobs - 1)
        pending = {p: pool.submit(load_scene, p, params, device)
                   for p in args.scenes}
    for scene_path in args.scenes:
        out = args.output or os.path.splitext(scene_path)[0] + ".exr"
        if args.skip_existing and os.path.exists(out):
            say(f"[skip] {out} exists")
            continue
        t0 = time.perf_counter()
        if pending is not None:
            scene, settings = pending[scene_path].result()
        else:
            scene, settings = load_scene(scene_path, params, device)
        if args.spp:
            settings.spp = args.spp
        if args.width:
            settings.width = args.width
        if args.height:
            settings.height = args.height
        say(f"[load] {scene_path}: {scene.geom.n_tris} tris, "
            f"{scene.emitters.n_emitters} emitters, "
            f"{settings.width}x{settings.height}@{settings.spp}spp "
            f"integrator={settings.integrator} on {device} "
            f"({time.perf_counter() - t0:.3f}s)")

        if args.nodes:
            from ..parallel.remote import render_distributed

            t1 = time.perf_counter()
            job = render_distributed(
                scene, settings, args.nodes.split(";"),
                include_local=args.local_worker, log=say)
            wall = time.perf_counter() - t1
            for e in job.errors:
                print(f"[cluster] {e}", file=sys.stderr, flush=True)
            save_render(out, job.image.cpu().numpy(), settings, metadata={
                "renderTime": f"{wall:.3f}s",
                "renderer": "mitsuba_im_tpu_torch"})
            say(f"[done] {out}  {wall:.3f}s (" + ", ".join(
                f"{k} {w.units} units" for k, w in job.workers.items())
                + ")")
            continue

        if settings.integrator in LOOP_INTEGRATORS:
            t1 = time.perf_counter()
            img = render(scene, settings).cpu().numpy()
            wall = time.perf_counter() - t1
            save_render(out, img, settings, metadata={
                "renderTime": f"{wall:.3f}s",
                "renderer": "mitsuba_im_tpu_torch"})
            say(f"[done] {out}  {wall:.3f}s ({settings.integrator})")
            continue

        if mesh is not None:
            from ..parallel.mesh import render_sharded, replicate_to_mesh

            t1 = time.perf_counter()
            img = render_sharded(mesh, replicate_to_mesh(scene, mesh),
                                 settings).cpu().numpy()
            wall = time.perf_counter() - t1
            save_render(out, img, settings, metadata={
                "renderTime": f"{wall:.3f}s",
                "renderer": "mitsuba_im_tpu_torch"})
            say(f"[done] {out}  {wall:.3f}s (sharded over {mesh.size} "
                f"rank(s))")
            continue

        if settings.tiled and out.endswith(".exr"):
            from ..film.tiled import render_tiled

            t1 = time.perf_counter()
            render_tiled(scene, settings, out, spp=settings.spp,
                         metadata={"renderer": "mitsuba_im_tpu_torch"})
            say(f"[done] {out}  {time.perf_counter() - t1:.3f}s (tiled "
                f"out-of-core)")
            continue

        film = None
        start_spp = 0
        if args.resume:
            from ..interactive.checkpoint import load_checkpoint

            film, start_spp, _ = load_checkpoint(args.resume, device)
            say(f"[resume] {start_spp} spp from {args.resume}")

        last_flush = [time.perf_counter()]

        def progress(done, total, film_now):
            if args.verbose:
                say(f"[render] {done + start_spp}/{total + start_spp} spp")
            if (args.flush_sec
                    and time.perf_counter() - last_flush[0] > args.flush_sec):
                save_render(out, develop(film_now), settings,
                            metadata={"spp": str(done + start_spp)})
                last_flush[0] = time.perf_counter()
            if args.progressive and done % args.progressive == 0:
                base, ext = os.path.splitext(out)
                save_render(f"{base}_{done + start_spp:05d}{ext}",
                            develop(film_now), settings)
            if args.checkpoint:
                from ..interactive.checkpoint import save_checkpoint

                save_checkpoint(args.checkpoint, film_now, done + start_spp,
                                settings)

        t1 = time.perf_counter()
        film = render_film(scene, settings, spp=settings.spp - start_spp,
                           film=film, sample_offset=start_spp,
                           progress_cb=progress)
        img = develop(film).cpu().numpy()
        wall = time.perf_counter() - t1
        save_render(out, img, settings, metadata={
            "renderTime": f"{wall:.3f}s", "renderer": "mitsuba_im_tpu_torch"})
        n_paths = settings.width * settings.height * (settings.spp
                                                      - start_spp)
        rate = n_paths / max(wall, 1e-9)
        say(f"[done] {out}  {wall:.3f}s ({rate / 1e6:.2f} Mpaths/s)")


if __name__ == "__main__":
    sys.exit(main())
