"""Rendering across render nodes over byte streams, and the ``mtssrv``
node (``mitsuba_im_tpu/parallel/remote.py``, a copy on the port's
renderer).

The protocol is the reference's byte for byte: a frame is ``<u32
header_len> <header json> <u32 n_blobs> (<u64 len> bytes)*``
(:func:`send_msg`, :func:`recv_msg`), with the message types hello,
has_resource/resource_status, new_resource/resource_ack, work_unit,
work_result/work_failed, ping/pong and quit (Mitsuba's
``sched_remote.h`` EMessage).  A node caches a resource by its content
hash across work units and connections, and each node connection keeps
up to ``BACKLOG`` work units in flight.  ``mtssrv -ls`` serves one
connection over stdin/stdout, so a node spec ``exec:ssh host python -m
mitsuba_im_tpu_torch.cli.mtssrv -ls`` spawns a node over a pipe; a plain
``host[:port]`` connects over TCP (port 7554 by default).

A work unit is a range of sample indices: a node renders the whole image
at those indices (``render/job.py::render_film`` with its
``sample_offset``) and returns the film's accumulation (the filter weight
included), so merging is a sum and the counter-based sampler makes the
image independent of how the samples were split.  The scene crosses the
wire as its tables (``scene/bridge.py::export_scene``: numpy arrays and
static values) and each node rebuilds it on its own device
(``scene_from_numpy``); tensors never cross it.

As in the reference, a node failure re-queues the node's units in flight
onto the surviving workers, and the job fails only when every worker has
failed.  A failure is never silent: :func:`render_distributed` logs each
worker's error and returns the errors with each worker's unit count and
seconds (:class:`ClusterRender`).  A short job is shared fairly: a node
keeps at most ``units // workers`` units in flight (at least one, at most
``BACKLOG``), so that one node does not take a job of a few units alone.

Trust model: the reference's.  The protocol authenticates nothing and is
meant for a trusted render farm; unpickling admits only the few globals a
resource names (:class:`_RestrictedUnpickler`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import pickle
import queue
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import torch

DEFAULT_PORT = 7554  # sched_remote.h:27
PROTOCOL_VERSION = 1
BACKLOG = 3  # in-flight work units per node (sched_remote.h:29-36)
PACKAGE = __name__.split(".")[0]

# ---------------------------------------------------------------------------
# framing: <u32 header_len> <header json> <u32 n_blobs> (<u64 len> bytes)*
# ---------------------------------------------------------------------------


def send_msg(wfile, header: dict, blobs: list[bytes] = ()) -> None:
    h = json.dumps(header).encode()
    wfile.write(struct.pack("<I", len(h)))
    wfile.write(h)
    wfile.write(struct.pack("<I", len(blobs)))
    for b in blobs:
        wfile.write(struct.pack("<Q", len(b)))
        wfile.write(b)
    wfile.flush()


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise ConnectionError("stream closed mid-message")
        buf += chunk
    return buf


def recv_msg(rfile):
    (hlen,) = struct.unpack("<I", _read_exact(rfile, 4))
    header = json.loads(_read_exact(rfile, hlen))
    (nblobs,) = struct.unpack("<I", _read_exact(rfile, 4))
    blobs = []
    for _ in range(nblobs):
        (blen,) = struct.unpack("<Q", _read_exact(rfile, 8))
        blobs.append(_read_exact(rfile, blen))
    return header, blobs


# ---------------------------------------------------------------------------
# resources: a scene's tables and its settings, pickled
# ---------------------------------------------------------------------------

# the globals a resource's pickle names (HIGHEST_PROTOCOL): its settings,
# a motion integrator's sensor animation, numpy's array, dtype and scalar
# reconstructors, and the builtin containers
_ALLOWED = {
    (f"{PACKAGE}.render.job", "RenderSettings"),
    (f"{PACKAGE}.core.track", "AnimatedTransform"),
    (f"{PACKAGE}.core.track", "AnimationTrack"),
    ("numpy", "dtype"), ("numpy", "ndarray"),
    *((m, n) for m in ("numpy._core.multiarray", "numpy.core.multiarray")
      for n in ("_reconstruct", "scalar")),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy.core.numeric", "_frombuffer"),
    *(("builtins", n) for n in ("dict", "list", "tuple", "set", "frozenset",
                                "complex")),
}


class _RestrictedUnpickler(pickle.Unpickler):
    """Admits only the globals a resource carries (``_ALLOWED``): the
    settings and sensor animation of this package, numpy's reconstructors
    and the builtin containers, by exact module and name (Mitsuba's
    registered-class-only unserialization, ``include/mitsuba/core/class.h``).
    Every other global is refused: any other class of this package (a
    ``RemoteNode`` starts a process in its constructor), the JAX package's
    classes, ``torch``'s, and numpy's functions (``numpy.load`` reads a file).
    The reference's ``startswith("mitsuba_im_tpu")`` admits both packages
    whole."""

    def find_class(self, module, name):
        if (module, name) in _ALLOWED:
            return super().find_class(module, name)
        if module == "numpy.dtypes" and "." not in name:  # dtype classes
            obj = getattr(getattr(np, "dtypes", None), name, None)
            if isinstance(obj, type) and issubclass(obj, np.dtype):
                return obj
        raise pickle.UnpicklingError(f"blocked class {module}.{name}")


def dumps_resource(scene, settings) -> bytes:
    """The scene's tables (``export_scene``) and its settings, pickled."""
    from ..scene.bridge import export_scene

    arrays, statics = export_scene(scene)
    return pickle.dumps({"arrays": arrays, "statics": statics,
                         "settings": settings},
                        protocol=pickle.HIGHEST_PROTOCOL)


def loads_resource(data: bytes, device="cuda"):
    """(Scene on ``device``, settings) of a resource."""
    from ..scene.bridge import scene_from_numpy

    payload = _RestrictedUnpickler(io.BytesIO(data)).load()
    scene = scene_from_numpy(payload["arrays"], payload["statics"], device)
    return scene, payload["settings"]


def resource_id(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:24]


# ---------------------------------------------------------------------------
# server side: the mtssrv node (StreamBackend, sched_remote.cpp:333)
# ---------------------------------------------------------------------------


class StreamBackend:
    """Serves the worker protocol over one (rfile, wfile) byte-stream pair,
    rendering on ``device`` (the card unless the CPU is asked for)."""

    def __init__(self, rfile, wfile, log=lambda *_: None,
                 resource_cache: dict | None = None, device="cuda"):
        from ..core.types import entry_device

        self.rfile, self.wfile = rfile, wfile
        self.log = log
        self.device = entry_device(device)
        # shared across connections: nodes cache resources by id
        self.resources = resource_cache if resource_cache is not None else {}
        self._scenes = {}

    def run(self) -> None:
        cuda = self.device.type == "cuda"
        send_msg(self.wfile, {
            "type": "hello", "version": PROTOCOL_VERSION,
            "devices": torch.cuda.device_count() if cuda else 1,
            "platform": self.device.type,
        })
        while True:
            try:
                header, blobs = recv_msg(self.rfile)
            except (ConnectionError, EOFError):
                return
            t = header.get("type")
            if t == "quit":
                return
            elif t == "new_resource":
                rid = header["id"]
                self.resources[rid] = blobs[0]
                send_msg(self.wfile, {"type": "resource_ack", "id": rid})
                self.log(f"resource {rid} cached ({len(blobs[0])} bytes)")
            elif t == "has_resource":
                send_msg(self.wfile, {"type": "resource_status",
                                      "id": header["id"],
                                      "cached": header["id"] in self.resources})
            elif t == "work_unit":
                self._process(header)
            elif t == "ping":
                send_msg(self.wfile, {"type": "pong"})
            else:
                # protocol garbage: drop the connection (sched_remote.cpp:344)
                self.log(f"unknown message type {t!r}, closing")
                return

    def _scene_for(self, rid: str):
        if rid not in self._scenes:
            if rid not in self.resources:
                raise KeyError(f"resource {rid} not registered")
            self._scenes[rid] = loads_resource(self.resources[rid],
                                               self.device)
        return self._scenes[rid]

    def _process(self, header: dict) -> None:
        from ..render.job import RenderSettings, render_film

        uid = header["unit_id"]
        try:
            scene, settings = self._scene_for(header["resource_id"])
            overrides = header.get("overrides") or {}
            if overrides:
                settings = RenderSettings(**{**settings.__dict__, **overrides})
            t0 = time.perf_counter()
            film = render_film(scene, settings, spp=header["count"],
                               sample_offset=header["sample_offset"])
            data = film.data.cpu().numpy()  # waits for the device
            wall = time.perf_counter() - t0
            send_msg(self.wfile, {
                "type": "work_result", "unit_id": uid,
                "count": header["count"], "shape": list(data.shape),
                "wall_s": wall,
            }, [data.tobytes()])
            self.log(f"unit {uid}: {header['count']} spp in {wall:.2f}s")
        except Exception as e:  # ECancelledWorkResult: report, keep serving
            send_msg(self.wfile, {"type": "work_failed", "unit_id": uid,
                                  "error": f"{type(e).__name__}: {e}"})
            self.log(f"unit {uid} FAILED: {e}")


def serve_stdio(log=lambda *_: None, device="cuda") -> None:
    """``mtssrv -ls``: speak the protocol over stdin/stdout."""
    rfile = sys.stdin.buffer
    wfile = sys.stdout.buffer
    # anything the render path prints must not corrupt the protocol stream
    sys.stdout = sys.stderr
    StreamBackend(rfile, wfile, log=log, device=device).run()


def serve_tcp(port: int = DEFAULT_PORT, host: str = "", log=lambda *_: None,
              ready_event: threading.Event | None = None,
              stop_event: threading.Event | None = None,
              device="cuda") -> None:
    """``mtssrv``: accept loop, one StreamBackend thread per connection."""
    cache: dict = {}
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(8)
    srv.settimeout(0.25)
    log(f"listening on port {port}")
    if ready_event is not None:
        ready_event.set()
    try:
        while stop_event is None or not stop_event.is_set():
            try:
                conn, addr = srv.accept()
            except socket.timeout:
                continue
            log(f"connection from {addr}")
            rfile = conn.makefile("rb")
            wfile = conn.makefile("wb")
            t = threading.Thread(
                target=StreamBackend(rfile, wfile, log=log,
                                     resource_cache=cache,
                                     device=device).run,
                daemon=True)
            t.start()
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# client side: the remote worker pool (sched_remote.h:50, :267)
# ---------------------------------------------------------------------------


class RemoteNode:
    """One connection to a render node; ``seconds`` holds the time from
    the spawn or connect to the node's hello (a spawned node's process
    start, imports and device initialisation)."""

    def __init__(self, spec):
        self.spec = spec if isinstance(spec, str) else " ".join(spec)
        self.proc = None
        t0 = time.perf_counter()
        if not isinstance(spec, str) or spec.startswith("exec:"):
            # pipe transport, which covers `exec:ssh user@host ... -ls`; a
            # list spec is used verbatim as the argv
            argv = list(spec) if not isinstance(spec, str) else spec[5:].split()
            self.proc = subprocess.Popen(
                argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            self.rfile, self.wfile = self.proc.stdout, self.proc.stdin
        else:
            host, _, port = spec.partition(":")
            sock = socket.create_connection((host, int(port or DEFAULT_PORT)),
                                            timeout=30)
            self.rfile = sock.makefile("rb")
            self.wfile = sock.makefile("wb")
        try:
            hello, _ = recv_msg(self.rfile)
        except ConnectionError:
            self.close()
            raise
        if hello.get("type") != "hello" or hello.get("version") != PROTOCOL_VERSION:
            self.close()
            raise ConnectionError(f"{self.spec}: bad hello {hello}")
        self.devices = hello.get("devices", 1)
        self.platform = hello.get("platform")
        self.seconds = time.perf_counter() - t0

    def ensure_resource(self, rid: str, payload: bytes) -> None:
        send_msg(self.wfile, {"type": "has_resource", "id": rid})
        status, _ = recv_msg(self.rfile)
        if not status.get("cached"):
            send_msg(self.wfile, {"type": "new_resource", "id": rid}, [payload])
            ack, _ = recv_msg(self.rfile)
            if ack.get("type") != "resource_ack":
                raise ConnectionError(f"{self.spec}: resource upload failed: {ack}")

    def send_unit(self, unit: dict) -> None:
        send_msg(self.wfile, {"type": "work_unit", **unit})

    def recv_result(self):
        header, blobs = recv_msg(self.rfile)
        if header.get("type") == "work_failed":
            raise RuntimeError(f"{self.spec}: {header.get('error')}")
        data = np.frombuffer(blobs[0], np.float32).reshape(header["shape"])
        return header, data

    def close(self) -> None:
        try:
            send_msg(self.wfile, {"type": "quit"})
        except (OSError, ValueError):
            pass
        for f in (self.rfile, self.wfile):
            try:
                f.close()
            except OSError:
                pass
        if self.proc is not None:
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


@dataclasses.dataclass
class WorkerStats:
    """One worker's share of a job: units and samples per pixel rendered,
    each unit's seconds (a node's as it reported them), the seconds to
    reach its hello and to ship it the resource (nodes), and its error
    (None while it works)."""

    units: int = 0
    spp: int = 0
    unit_seconds: list = dataclasses.field(default_factory=list)
    connect_seconds: float | None = None
    ship_seconds: float | None = None
    error: str | None = None


@dataclasses.dataclass
class ClusterRender:
    """A distributed render: the developed (H, W, 3) image on the scene's
    device, each worker's stats by name (a node by its spec, ``"local"``
    for this process), the workers' errors and the resource's bytes."""

    image: torch.Tensor
    workers: dict
    errors: list
    resource_bytes: int


def render_distributed(scene, settings, nodes: list, spp: int | None = None,
                       unit_spp: int | None = None, include_local: bool = True,
                       log=lambda *_: None) -> ClusterRender:
    """Render ``spp`` samples split across render nodes (and this process).

    ``nodes`` holds specs (``host[:port]``, ``exec:CMD`` or an argv list)
    or connected :class:`RemoteNode` objects.  The resource is registered
    once per node, units stream to the workers and their films are summed
    as they come back.  A failed node's units in flight are re-queued for
    the survivors (sched_remote.cpp:293-308); the job raises only if every
    worker fails, and every failure is logged and returned."""
    from ..film.film import Film, develop, make_film
    from ..render.job import render_film

    spp = spp if spp is not None else settings.spp
    payload = dumps_resource(scene, settings)
    rid = resource_id(payload)

    n_workers = len(nodes) + (1 if include_local else 0)
    if unit_spp is None:
        unit_spp = max(1, spp // (BACKLOG * max(n_workers, 1) * 2))
    units = []
    off = 0
    while off < spp:
        cnt = min(unit_spp, spp - off)
        units.append({"unit_id": len(units), "resource_id": rid,
                      "sample_offset": off, "count": cnt})
        off += cnt
    backlog = min(BACKLOG, max(1, len(units) // max(n_workers, 1)))

    work_q: queue.Queue = queue.Queue()
    for u in units:
        work_q.put(u)
    results: queue.Queue = queue.Queue()
    done_flag = threading.Event()  # set by the merger once all spp landed
    names = []  # a worker's name: its spec, numbered when repeated
    for n in nodes:
        name = n.spec if isinstance(n, RemoteNode) else (
            n if isinstance(n, str) else " ".join(n))
        k = sum(1 for m in names if m.split(" #")[0] == name)
        names.append(name if k == 0 else f"{name} #{k + 1}")
    workers = {name: WorkerStats() for name in names}
    if include_local:
        workers["local"] = WorkerStats()

    def node_loop(spec, name: str) -> None:
        stats = workers[name]
        inflight: list[dict] = []
        node = spec if isinstance(spec, RemoteNode) else None
        try:
            if node is None:
                node = RemoteNode(spec)
            stats.connect_seconds = node.seconds
            t0 = time.perf_counter()
            node.ensure_resource(rid, payload)
            stats.ship_seconds = time.perf_counter() - t0
            while not done_flag.is_set():
                while len(inflight) < backlog:
                    try:
                        u = work_q.get_nowait()
                    except queue.Empty:
                        break
                    node.send_unit(u)
                    inflight.append(u)
                if not inflight:
                    # stay connected until the job ends: a failed peer's
                    # units may be re-queued
                    done_flag.wait(timeout=0.2)
                    continue
                header, data = node.recv_result()
                done = next(u for u in inflight
                            if u["unit_id"] == header["unit_id"])
                inflight.remove(done)
                stats.unit_seconds.append(header.get("wall_s"))
                results.put(("ok", name, data, done["count"]))
        except Exception as e:  # a node's boundary: report it, re-queue
            for u in inflight:
                work_q.put(u)
            results.put(("err", name, f"{name}: {type(e).__name__}: {e}", 0))
        finally:
            if node is not None:
                node.close()

    def local_loop() -> None:
        u = None
        try:
            while not done_flag.is_set():
                try:
                    u = work_q.get(timeout=0.2)
                except queue.Empty:
                    continue
                t0 = time.perf_counter()
                film = render_film(scene, settings, spp=u["count"],
                                   sample_offset=u["sample_offset"])
                data = film.data.cpu().numpy()  # waits for the device
                workers["local"].unit_seconds.append(time.perf_counter() - t0)
                results.put(("ok", "local", data, u["count"]))
                u = None
        except Exception as e:  # the local worker's boundary, as a node's
            if u is not None:
                work_q.put(u)
            results.put(("err", "local", f"local: {type(e).__name__}: {e}",
                         0))

    threads = [threading.Thread(target=node_loop, args=(s, name),
                                daemon=True)
               for s, name in zip(nodes, names)]
    if include_local:
        threads.append(threading.Thread(target=local_loop, daemon=True))
    for t in threads:
        t.start()

    live_workers = n_workers
    errors: list[str] = []
    accum = None
    n_done = 0
    try:
        while n_done < spp:
            if live_workers == 0:
                raise RuntimeError(
                    "all render workers failed: " + "; ".join(errors))
            kind, name, data, cnt = results.get()
            if kind == "err":
                errors.append(data)
                workers[name].error = data
                live_workers -= 1
                log(f"[cluster] worker failed ({data}); {live_workers} remain")
                continue
            workers[name].units += 1
            workers[name].spp += cnt
            accum = data.copy() if accum is None else accum + data
            n_done += cnt
            log(f"[cluster] {n_done}/{spp} spp")
    finally:
        done_flag.set()
        for t in threads:
            t.join(timeout=30)

    proto = make_film(settings.width, settings.height, settings.rfilter,
                      settings.rfilter_radius, device="cpu")
    film = Film(data=torch.from_numpy(accum), width=settings.width,
                height=settings.height, ftype=proto.ftype, radius=proto.radius)
    return ClusterRender(image=develop(film).to(scene.device),
                         workers=workers, errors=errors,
                         resource_bytes=len(payload))
