"""Rendering across processes: pixels sharded over a ``torch.distributed``
process group (``mitsuba_im_tpu/parallel/mesh.py``).

The reference shards a jitted pass over a JAX device mesh with
``shard_map`` and sums the partial films with one ``psum``.  Here the mesh
is a process group, one process (rank) a card: ``gloo`` for CPU tensors,
``nccl`` for the card.  The scene is replicated into every rank's memory
(:func:`replicate_to_mesh` broadcasts its tensors from rank 0), the pixel
range is padded to a multiple of the world size and each rank renders the
contiguous block ``shard_map``'s ``P(axis)`` gives it (mesh.py:85-86), the
pad lanes splatting nothing (:102), and one ``all_reduce`` of each rank's
film delta, added back to the film it started from, stands for the
``psum`` (:107).  A rank's pass is ``render/job.py::render_pass`` on its
lanes, so at world size 1 it is ``render_film``'s pass.

The reference shards ``path_li`` alone (mesh.py:128-144), so under ``-m``
it renders a ``volpath``, ``direct``, ``ao``, ``field`` or ``motion``
scene as ``path`` (ROADMAP C30).  The port shards the settings'
integrator (``render/job.py::integrator_fn``), on ``path`` the reference's
computation; the integrators with render loops of their own
(``LOOP_INTEGRATORS``) are refused, as the command line renders them
through ``render`` before it reaches ``-m``.  A grid medium's image
depends on the batch (``integrators/volpath.py``), so a sharded
``volpath`` over one differs from ``render_film``'s as a tiled one does.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..core.types import entry_device
from ..film.film import develop, make_film
from ..render.job import (LOOP_INTEGRATORS, RenderSettings, integrator_fn,
                          render_pass, sampler_kind)
from ..scene.scene import Scene


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group seen from one rank: its rank, the world size, the
    device its tensors live on and the group (None: a world of one with no
    group, where no collective runs)."""

    rank: int
    size: int
    device: torch.device
    group: object = None


def _rank_device(device, rank: int) -> torch.device:
    dev = entry_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_mesh(device="cuda") -> Mesh:
    """The mesh of the default process group when one is initialized, else
    a world of one; this rank's tensors on ``device`` (the card unless the
    CPU is asked for; with several cards, card ``rank % count``)."""
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        return Mesh(rank, size, _rank_device(device, rank), dist.group.WORLD)
    return Mesh(0, 1, _rank_device(device, 0))


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda") -> Mesh:
    """Join a process group and return its mesh: ``nccl`` for the card,
    ``gloo`` for the CPU.  ``coordinator_address`` is ``host:port`` of rank
    0 with ``num_processes`` ranks, this one ``process_id``.  Without it,
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when it is set, else a world of one with no group.
    An initialized group is joined as it is."""
    if dist.is_initialized():
        return make_mesh(device)
    if coordinator_address is None and not (
            "RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return make_mesh(device)
    if coordinator_address is not None:
        rank, size = int(process_id), int(num_processes)
        init_method = f"tcp://{coordinator_address}"
    else:
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, world_size=size,
                            rank=rank)
    return make_mesh(dev)


def _tensors(tree):
    """Every tensor leaf of a tree of dataclasses, dicts and sequences, in
    field order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate_to_mesh(tree, mesh: Mesh):
    """Broadcast every tensor leaf of ``tree`` (a Scene, say) from rank 0
    into this rank's tensors, in place; returns ``tree``.  The ranks must
    hold trees of the same structure and shapes (one scene file loaded by
    each)."""
    if mesh.group is None:
        return tree
    for t in _tensors(tree):
        buf = t.view(torch.uint8) if t.dtype == torch.bool else t
        dist.broadcast(buf, src=0, group=mesh.group)
    return tree


def shard_lanes(mesh: Mesh, n: int) -> torch.Tensor:
    """This rank's flat pixel lanes of an ``n``-pixel image: its block of
    the range padded to a multiple of the world size."""
    per = (n + (-n) % mesh.size) // mesh.size
    lo = mesh.rank * per
    return torch.arange(lo, lo + per, dtype=torch.int64, device=mesh.device)


def render_pass_sharded(mesh: Mesh, scene: Scene, settings: RenderSettings):
    """fn(scene, film, sample_idx, seed) -> film: one sample per pixel of
    the settings' integrator, this rank's lanes splatted into its film and
    the ranks' deltas summed into every rank's film."""
    if settings.integrator in LOOP_INTEGRATORS:
        raise NotImplementedError(
            f"integrator '{settings.integrator}' renders through "
            "render/job.py::render, not sharded")
    pix = shard_lanes(mesh, settings.width * settings.height)
    li_fn = integrator_fn(settings)
    kind = sampler_kind(settings)

    def run(scene, film, sample_idx, seed):
        film0 = film.data.clone() if mesh.group is not None else None
        film = render_pass(scene, film, sample_idx, seed, li_fn, kind,
                           settings.spp, pix=pix)
        if mesh.group is not None:
            delta = film.data - film0
            dist.all_reduce(delta, group=mesh.group)
            film.data.copy_(film0 + delta)
        return film

    return run


def render_sharded(mesh: Mesh, scene: Scene, settings: RenderSettings,
                   spp: int | None = None) -> torch.Tensor:
    """The developed (H, W, 3) image of ``spp`` sharded passes, the same on
    every rank, on the rank's device."""
    spp = spp or settings.spp
    run = render_pass_sharded(mesh, scene, settings)
    film = make_film(settings.width, settings.height, settings.rfilter,
                     settings.rfilter_radius, device=scene.device)
    with torch.no_grad():
        for s in range(spp):
            film = run(scene, film, s, settings.seed)
    return develop(film)
