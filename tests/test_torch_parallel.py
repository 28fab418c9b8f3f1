"""Port vs reference: rendering across processes and render nodes
(``mitsuba_im_tpu_torch/parallel/``, ``cli/mtssrv.py``, the command
line's ``-m`` and ``--nodes``), on the CPU over loopback and pipes.

The framing is the reference's byte for byte; the restricted unpickler
refuses what the reference's refuses and also the JAX package's classes,
``torch``'s, numpy's functions and this package's classes but the few a
resource carries; a scene's resource round-trips bit for bit.  A node's
work unit is ``render_film``'s film at its ``sample_offset`` bit for bit;
a distributed render (a stdio node and the local worker, or a loopback
TCP node alone) and two
``gloo`` ranks of the command line's ``-m`` (a 15 x 17 image, so that
the pad lanes run) are ``render_film``'s image within atol 1e-5 (the
films are summed in another order), and the ranks' image passes
parity_check.py's gate against the reference's ``render_sharded`` on 2
of the 8 host devices.  Subprocess nodes and ranks run 2 threads each.
"""
import io
import os
import pickle
import socket
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from test_torch_helpers import assert_same_scene, parity_gate
from test_render import CORNELL_XML

from mitsuba_im_tpu.parallel import remote as jremote
from mitsuba_im_tpu.parallel.mesh import make_mesh as jmake_mesh
from mitsuba_im_tpu.parallel.mesh import render_sharded as jrender_sharded
from mitsuba_im_tpu.scene.xml import load_scene as jload
from mitsuba_im_tpu_torch import scenes
from mitsuba_im_tpu_torch.cli.main import main
from mitsuba_im_tpu_torch.core.track import AnimatedTransform, AnimationTrack
from mitsuba_im_tpu_torch.core.transform import Transform
from mitsuba_im_tpu_torch.film.film import develop
from mitsuba_im_tpu_torch.parallel import mesh as tmesh
from mitsuba_im_tpu_torch.parallel import remote
from mitsuba_im_tpu_torch.render.job import RenderSettings, render_film
from mitsuba_im_tpu_torch.scene.xml import load_scene

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": ROOT}
NODE = [sys.executable, "-c",
        "import torch; torch.set_num_threads(2); "
        "from mitsuba_im_tpu_torch.cli.mtssrv import main; "
        "main(['-ls', '-q', '--device', 'cpu'])"]
# a node that says hello, claims to hold every resource and dies on its
# first work unit (framing by hand: it imports nothing of the package)
DYING = [sys.executable, "-c", """
import json, struct, sys
r, w = sys.stdin.buffer, sys.stdout.buffer
def send(h):
    b = json.dumps(h).encode()
    w.write(struct.pack('<I', len(b)) + b + struct.pack('<I', 0))
    w.flush()
send({'type': 'hello', 'version': 1})
while True:
    h = json.loads(r.read(struct.unpack('<I', r.read(4))[0]))
    r.read(4)
    if h['type'] == 'work_unit':
        sys.exit(1)
    send({'type': 'resource_status', 'id': h['id'], 'cached': True})
"""]


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    """The scene file of tests/test_render.py at 16^2, depth 3, 4 spp, and
    the port's scene of it on the CPU."""
    d = tmp_path_factory.mktemp("parallel")
    path = str(d / "cornell.xml")
    with open(path, "w") as f:
        f.write(CORNELL_XML.format(max_depth=3, spp=4, res=16))
    scene, settings = load_scene(path, device="cpu")
    return d, path, scene, settings


def _image(scene, settings, **kw):
    return develop(render_film(scene, settings, **kw)).numpy()


def test_framing_bytes_match_reference():
    for header, blobs in (({"type": "x", "n": 3}, [b"abc", b""]),
                          ({"type": "work_unit", "unit_id": 7}, []),
                          ({"type": "y", "s": "é"}, [bytes(range(256))])):
        a, b = io.BytesIO(), io.BytesIO()
        remote.send_msg(a, header, blobs)
        jremote.send_msg(b, header, blobs)
        assert a.getvalue() == b.getvalue()
        a.seek(0)
        assert remote.recv_msg(a) == (header, list(blobs))
    assert (remote.DEFAULT_PORT, remote.PROTOCOL_VERSION, remote.BACKLOG) == (
        jremote.DEFAULT_PORT, jremote.PROTOCOL_VERSION, jremote.BACKLOG)


def _load(data: bytes):
    return remote._RestrictedUnpickler(io.BytesIO(data)).load()


def _call(module: str, name: str, *args: str) -> bytes:
    """A protocol-4 pickle that calls ``module.name(*args)`` (GLOBAL and
    REDUCE, string arguments)."""
    def u(x):
        b = x.encode()
        return b"\x8c" + bytes([len(b)]) + b
    return (b"\x80\x04" + u(module) + u(name) + b"\x93"
            + b"(" + b"".join(u(a) for a in args) + b"tR.")


def test_unpickler_refusals(tmp_path):
    """As tests/test_remote.py:46, and the JAX package's classes, torch's,
    numpy's functions and every class of this package but the few a
    resource carries: a ``RemoteNode('exec:CMD')`` would start CMD."""
    from mitsuba_im_tpu.scene.build import RenderSettings as JSettings

    for evil in (pickle.dumps(os.system), pickle.dumps(JSettings()),
                 pickle.dumps(torch.zeros(2)), pickle.dumps(subprocess.Popen),
                 pickle.dumps(remote.RemoteNode),
                 pickle.dumps(remote.StreamBackend), pickle.dumps(np.load)):
        with pytest.raises(pickle.UnpicklingError, match="blocked"):
            _load(evil)
    mod = "mitsuba_im_tpu_torch.parallel.remote"
    mark = tmp_path / "started"
    for evil in (_call(mod, "subprocess.Popen", "true"),
                 _call(mod, "RemoteNode", f"exec:touch {mark}"),
                 _call(mod, "StreamBackend", "r", "w"),
                 _call("numpy", "load", str(mark)),
                 _call("numpy.dtypes", "np.load", str(mark))):
        with pytest.raises(pickle.UnpicklingError, match="blocked"):
            _load(evil)
    assert not mark.exists()
    anim = AnimatedTransform([0.0, 1.0], [Transform(np.eye(4)),
                                          Transform(np.diag([2, 1, 1, 1]))])
    ok = {"s": RenderSettings(width=3, integrator_props={
              "sensor_animation": anim, "track": AnimationTrack([0], [1])}),
          "a": np.arange(4, dtype=np.float32), "t": (1, 2.5, "x"),
          "f": np.float32(2), "d": np.dtype(np.int64)}
    got = _load(pickle.dumps(ok, protocol=pickle.HIGHEST_PROTOCOL))
    assert got["t"] == ok["t"] and got["d"] == ok["d"]
    assert got["s"].width == 3 and got["f"] == ok["f"]
    np.testing.assert_array_equal(got["a"], ok["a"])
    np.testing.assert_array_equal(
        got["s"].integrator_props["sensor_animation"].eval(0.5).m,
        anim.eval(0.5).m)


@pytest.mark.parametrize("make", ["tiny_cornell", "subsurface_cornell"])
def test_resource_round_trip(make):
    """A scene crosses the wire as its tables and comes back bit for bit
    (the subsurface table's traced irradiance included)."""
    kw = {} if make == "tiny_cornell" else {"res": 16}
    scene, settings = getattr(scenes, make)("cpu", **kw)
    settings.integrator_props = dict(max_depth=3)
    payload = remote.dumps_resource(scene, settings)
    assert len(remote.resource_id(payload)) == 24
    scene2, settings2 = remote.loads_resource(payload, "cpu")
    assert_same_scene(scene2, scene)
    if scene.subsurface is not None:
        assert torch.equal(scene2.subsurface.irr, scene.subsurface.irr)
    assert settings2 == settings


def test_stream_backend_unit(cornell):
    """One work unit over a socketpair: the film of render_film at the
    unit's sample offset, bit for bit; an unknown resource fails the unit
    and the connection serves on."""
    _, _, scene, settings = cornell
    a, b = socket.socketpair()
    backend = remote.StreamBackend(b.makefile("rb"), b.makefile("wb"),
                                   device="cpu")
    t = threading.Thread(target=backend.run, daemon=True)
    t.start()
    rfile, wfile = a.makefile("rb"), a.makefile("wb")
    hello, _ = remote.recv_msg(rfile)
    assert hello == {"type": "hello", "version": 1, "devices": 1,
                     "platform": "cpu"}
    node = object.__new__(remote.RemoteNode)
    node.spec, node.rfile, node.wfile = "pair", rfile, wfile
    payload = remote.dumps_resource(scene, settings)
    rid = remote.resource_id(payload)
    node.ensure_resource(rid, payload)
    node.send_unit({"unit_id": 7, "resource_id": rid, "sample_offset": 2,
                    "count": 2})
    header, data = node.recv_result()
    assert header["unit_id"] == 7 and header["count"] == 2
    ref = render_film(scene, settings, spp=2, sample_offset=2).data.numpy()
    np.testing.assert_array_equal(data, ref)
    node.send_unit({"unit_id": 8, "resource_id": "nope", "sample_offset": 0,
                    "count": 1})
    with pytest.raises(RuntimeError, match="not registered"):
        node.recv_result()
    remote.send_msg(wfile, {"type": "ping"})
    assert remote.recv_msg(rfile)[0] == {"type": "pong"}
    remote.send_msg(wfile, {"type": "quit"})
    t.join(timeout=10)
    assert not t.is_alive()
    a.close()
    b.close()


def test_render_distributed(cornell):
    """A stdio node (``mtssrv -ls`` on the CPU) and the local worker
    against render_film; a node that dies at once (``exec:false``) and one
    that dies with a unit in flight have their errors listed, and the
    survivors render their share (the unit in flight re-queued)."""
    _, _, scene, settings = cornell
    ref = _image(scene, settings)
    # connected first, so that each takes a unit before the local worker
    # has rendered them all
    node, dying = remote.RemoteNode(NODE), remote.RemoteNode(DYING)
    job = remote.render_distributed(scene, settings,
                                    [node, "exec:false", dying], unit_spp=1)
    np.testing.assert_allclose(job.image.numpy(), ref, atol=1e-5)
    assert len(job.errors) == 2, job.errors
    for name in ("exec:false", dying.spec):
        assert job.workers[name].units == 0
        assert job.workers[name].error in job.errors
    assert "ConnectionError" in job.workers[dying.spec].error
    units = {k: w.units for k, w in job.workers.items()}
    assert units[node.spec] >= 1 and units["local"] >= 1, units
    assert sum(w.spp for w in job.workers.values()) == settings.spp
    assert job.workers[node.spec].connect_seconds > 0
    with pytest.raises(RuntimeError, match="all render workers failed"):
        remote.render_distributed(scene, settings, ["exec:false"],
                                  include_local=False)


def test_tcp_node_alone(cornell):
    """A ``host:port`` node (``serve_tcp`` on loopback, in a thread) renders
    the whole job without the local worker: render_film's image; a second
    job finds the resource cached on the node."""
    _, _, scene, settings = cornell
    port = _free_port()
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=remote.serve_tcp, kwargs=dict(
        port=port, host="127.0.0.1", ready_event=ready, stop_event=stop,
        device="cpu"), daemon=True)
    t.start()
    try:
        assert ready.wait(timeout=30)
        spec = f"127.0.0.1:{port}"
        job = remote.render_distributed(scene, settings, [spec],
                                        include_local=False, unit_spp=2)
        np.testing.assert_allclose(job.image.numpy(), _image(scene, settings),
                                   atol=1e-5)
        assert not job.errors and job.workers[spec].units == 2
        node = remote.RemoteNode(spec)
        payload = remote.dumps_resource(scene, settings)
        remote.send_msg(node.wfile, {"type": "has_resource",
                                     "id": remote.resource_id(payload)})
        assert remote.recv_msg(node.rfile)[0]["cached"] is True
        node.close()
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_ranks_through_the_command_line(cornell):
    """Two gloo ranks of ``-m`` under torchrun's variables at 15 x 17
    (255 pixels: rank 1's last lane is a pad lane): rank 0's image is
    render_film's and passes the gate against the reference's
    render_sharded on 2 host devices; a world of one in this process is
    render_film's too, and a loop integrator is refused."""
    d, path, _, _ = cornell
    out = str(d / "ranks.npy")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mitsuba_im_tpu_torch", path, "-m", "-q",
         "--device", "cpu", "--width", "15", "--height", "17", "-s", "2",
         "-o", out if r == 0 else str(d / "rank1.npy")],
        env={**ENV, "RANK": str(r), "WORLD_SIZE": "2",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port})
        for r in range(2)]
    # the references while the ranks run
    scene, settings = load_scene(path, device="cpu")
    settings.width, settings.height, settings.spp = 15, 17, 2
    ref = _image(scene, settings)
    jscene, jsettings = jload(path)
    jsettings.width, jsettings.height, jsettings.spp = 15, 17, 2
    jimg = jrender_sharded(jmake_mesh(jax.devices()[:2]), jscene, jsettings)
    for p in procs:
        assert p.wait(timeout=120) == 0
    assert not os.path.exists(d / "rank1.npy")
    img = np.load(out)
    np.testing.assert_allclose(img, ref, atol=1e-5)
    gate = parity_gate(img, np.asarray(jimg))
    assert gate["ok"], gate
    one = tmesh.make_mesh("cpu")
    assert (one.rank, one.size, one.group) == (0, 1, None)
    np.testing.assert_array_equal(
        tmesh.render_sharded(one, scene, settings).numpy(), ref)
    lanes = tmesh.shard_lanes(tmesh.Mesh(1, 2, torch.device("cpu")), 255)
    assert lanes[0] == 128 and lanes[-1] == 255
    settings.integrator = "bdpt"
    with pytest.raises(NotImplementedError, match="not sharded"):
        tmesh.render_pass_sharded(one, scene, settings)


def test_nodes_through_the_command_line(cornell, monkeypatch):
    """``--nodes`` with an ``exec:`` stdio node: the image is
    render_film's; with ``--no-local-worker`` the node renders alone."""
    d, path, scene, settings = cornell
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setenv("PYTHONPATH", ROOT)
    node = (f"exec:{sys.executable} -m mitsuba_im_tpu_torch.cli.mtssrv -ls "
            "-q --device cpu")
    out = str(d / "nodes.npy")
    assert main([path, "--nodes", node, "--no-local-worker", "-q",
                 "--device", "cpu", "-o", out]) == 0
    np.testing.assert_allclose(np.load(out), _image(scene, settings),
                               atol=1e-5)
