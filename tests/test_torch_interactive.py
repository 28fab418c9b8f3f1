"""Port vs reference: the interactive renderer
(``mitsuba_im_tpu_torch/interactive/``: the actor, the terminal shell and
the configurator) and the animated transform (``core/track.py``) with the
motion integrator's ``sensor_animation``, on the CPU.

The actor's film after k passes is ``render_film``'s k-spp film bit for
bit (the Cornell box's independent sampler and box filter), also after a
pause and after a camera move, and its preview is ``render_film``'s
one-pass box film at the reduced resolution; ``frame_to_ansi`` is the
reference's byte for byte, ``FlyCamera``'s poses its poses within 1e-12;
the configurator's parameter schemas are the reference's for every
category; ``AnimatedTransform.eval`` is the reference's bit for bit and a
motion image through a sensor animation within the motion test's
tolerance (rel 1e-5, atol 1e-4, ``tests/test_torch_simple.py``).
"""
import copy
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from test_torch_helpers import jax_cornell, npy
from test_render import CORNELL_XML

from mitsuba_im_tpu.core import track as jtrack
from mitsuba_im_tpu.core.transform import Transform as JTransform
from mitsuba_im_tpu.interactive import configurator as jconf
from mitsuba_im_tpu.interactive import shell as jshell
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu_torch.core import track
from mitsuba_im_tpu_torch.core.registry import CATEGORIES
from mitsuba_im_tpu_torch.core.transform import Transform
from mitsuba_im_tpu_torch.film.film import F_BOX, develop
from mitsuba_im_tpu_torch.interactive import configurator as conf
from mitsuba_im_tpu_torch.interactive import shell
from mitsuba_im_tpu_torch.interactive.actor import RenderActor
from mitsuba_im_tpu_torch.render.job import render_film
from mitsuba_im_tpu_torch.scene.xml import load_scene
from mitsuba_im_tpu_torch.scenes import tiny_cornell

torch.set_num_threads(2)

RES = 16


@pytest.fixture
def cornell():
    scene, settings = tiny_cornell("cpu")
    settings.width = settings.height = RES
    settings.spp = 4
    settings.integrator_props = dict(max_depth=3)
    return scene, settings


def _film_image(scene, settings, spp):
    return develop(render_film(scene, settings, spp=spp)).numpy()


class Recording(RenderActor):
    """The actor with every revision it publishes kept."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.revisions = []

    def _publish(self, film, spp, scale):
        super()._publish(film, spp, scale)
        self.revisions.append(self.latest())


def _wait(cond, seconds=60.0):
    deadline = time.time() + seconds
    while not cond():
        assert time.time() < deadline, "timed out"
        time.sleep(0.01)


def _parked(actor):
    """After ``pause``: wait until the pass in flight has landed and the
    render thread waits; returns the revision's generation and the
    count."""
    assert actor.parked.wait(timeout=60)
    return actor.latest().generation, actor.spp_done


def test_actor_revisions_pause_and_exact_resume(cornell):
    """A preview at 1/2 resolution, then full-resolution passes; paused
    after the first, no pass runs; resumed, the film after 4 passes is
    render_film's 4-spp film bit for bit, as each revision is its k-spp
    film."""
    scene, settings = cornell
    actor = Recording(scene, settings, preview_scale=2, max_spp=4)
    actor.pause(True)
    actor.start()
    time.sleep(0.05)
    assert actor.latest() is None  # paused before the first pass
    actor.pause(False)
    _wait(lambda: actor.spp_done >= 1)
    actor.pause(True)
    g, n = _parked(actor)
    time.sleep(0.3)
    assert (actor.latest().generation, actor.spp_done) == (g, n)
    actor.pause(False)
    actor._thread.join(timeout=60)
    assert not actor._thread.is_alive() and actor.error is None
    revs = actor.revisions
    assert [r.generation for r in revs] == list(range(1, 6))
    assert [(r.spp, r.resolution_scale) for r in revs] == [
        (1, 2), (1, 1), (2, 1), (3, 1), (4, 1)]
    prev = dataclasses.replace(settings, width=8, height=8, rfilter=F_BOX,
                               rfilter_radius=0.5)
    np.testing.assert_array_equal(revs[0].image,
                                  _film_image(scene, prev, 1))
    for r in revs[1:]:
        np.testing.assert_array_equal(r.image,
                                      _film_image(scene, settings, r.spp))
    assert len(actor.pass_times) == 4


def test_actor_camera_update(cornell):
    """A camera move restarts accumulation: a new preview revision with a
    higher generation, spp_done from 0, and the film of the moved scene
    render_film's bit for bit."""
    scene, settings = cornell
    actor = RenderActor(scene, settings, preview_scale=2).start()
    try:
        _wait(lambda: actor.spp_done >= 2)
        actor.pause(True)
        g, _ = _parked(actor)
        cam = shell.FlyCamera(scene.sensor.to_world.numpy())
        cam.move(dz=1.0)
        t = cam.to_world()
        moved = dataclasses.replace(scene, sensor=dataclasses.replace(
            scene.sensor,
            to_world=torch.tensor(t.m, dtype=torch.float32),
            to_camera=torch.tensor(t.inv, dtype=torch.float32)))
        actor.update_scene(moved)
        actor.pause(False)
        _wait(lambda: actor.latest().generation > g)
        rev = actor.latest()
        assert rev.generation == g + 1 and rev.resolution_scale == 2
        _wait(lambda: actor.latest().generation >= g + 3)
    finally:
        actor.stop()
    rev = actor.latest()
    assert rev.resolution_scale == 1 and 2 <= rev.spp <= actor.spp_done
    np.testing.assert_array_equal(rev.image,
                                  _film_image(moved, settings, rev.spp))
    assert not np.array_equal(rev.image, _film_image(scene, settings,
                                                     rev.spp))


def test_frame_to_ansi_and_fly_camera_match_reference():
    rng = np.random.default_rng(3)
    img = (rng.random((37, 53, 3)) * 1.5).astype(np.float32)
    for cols, rows, exposure, status in ((40, 11, 1.0, "hi"),
                                         (80, 24, 0.7, "x" * 100),
                                         (7, 3, 2.0, "")):
        a = shell.frame_to_ansi(img, cols, rows, exposure, status)
        assert a.encode() == jshell.frame_to_ansi(
            img, cols, rows, exposure, status).encode()
    a = shell.frame_to_ansi(img, 40, 11)
    assert len(a.split("\n")) == 11 and a.count("▀") == 40 * 10
    m = Transform.look_at([1.0, 2.0, 3.0], [0.0, 1.0, 0.5], [0, 1, 0]).m
    jm = JTransform.look_at([1.0, 2.0, 3.0], [0.0, 1.0, 0.5], [0, 1, 0]).m
    np.testing.assert_array_equal(m, jm)
    cam, jcam = shell.FlyCamera(m), jshell.FlyCamera(np.asarray(jm))
    for step in ((("move",), dict(dz=1.0)), (("look",), dict(dyaw=1)),
                 (("move",), dict(dx=-1, dy=1)),
                 (("look",), dict(dpitch=30)),
                 (("move",), dict(dz=-1.0, speed=0.5))):
        for c in (cam, jcam):
            getattr(c, step[0][0])(**step[1])
        np.testing.assert_allclose(cam.pos, jcam.pos, atol=1e-12)
        assert (cam.yaw, cam.pitch) == (jcam.yaw, jcam.pitch)
        np.testing.assert_allclose(cam.to_world().m,
                                   np.asarray(jcam.to_world().m), atol=1e-12)
    assert cam.pitch == 1.45  # clamped


@pytest.fixture(scope="module")
def xml_cornell(tmp_path_factory):
    d = tmp_path_factory.mktemp("shell")
    path = str(d / "s.xml")
    with open(path, "w") as f:
        f.write(CORNELL_XML.format(max_depth=3, spp=1, res=RES))
    return path


def test_terminal_shell_headless(xml_cornell, tmp_path):
    """Keys, frames and hot reload, as tests/test_shell.py, without a
    terminal."""
    scene, settings = load_scene(xml_cornell, device="cpu")
    sh = shell.TerminalShell(scene, settings, scene_path=xml_cornell,
                             preview_scale=2)
    assert sh.render_frame(60, 18).startswith("\x1b[H waiting")
    sh.actor.start()
    try:
        _wait(lambda: sh.actor.latest() is not None)
        frame = sh.render_frame(60, 18)
        assert "▀" in frame and " spp | gen " in frame
        assert frame.count("\n") == 17
        gen0 = sh.actor.latest().generation
        to_world0 = sh.scene.sensor.to_world.clone()
        sh.handle_key("w")
        assert sh._dirty_cam
        sh.flush_camera()
        assert not sh._dirty_cam
        assert not torch.equal(sh.scene.sensor.to_world, to_world0)
        torch.testing.assert_close(
            sh.scene.sensor.to_camera,
            torch.linalg.inv(sh.scene.sensor.to_world), atol=1e-5,
            rtol=1e-5)
        _wait(lambda: sh.actor.latest().generation > gen0)
        e0 = sh.exposure
        sh.handle_key("]")
        assert sh.exposure == e0 * 1.4
        sh.handle_key("[")
        assert sh.exposure == pytest.approx(e0)
        sh.handle_key("p")
        assert sh.actor.controls.paused
        assert "PAUSED" in sh.render_frame(60, 18)
        sh.handle_key("p")
        sh.handle_key("UP")
        assert sh._dirty_cam
        sh.handle_key("q")
        assert sh.quit
    finally:
        sh.actor.stop()
    assert not sh.actor._thread.is_alive()

    live = str(tmp_path / "live.xml")
    with open(xml_cornell) as f:
        text = f.read()
    with open(live, "w") as f:
        f.write(text)
    sh = shell.TerminalShell(scene, settings, scene_path=live,
                             preview_scale=2)
    old = sh.scene
    sh.check_reload()
    assert sh.scene is old  # unchanged mtime
    with open(live, "w") as f:
        f.write(text.replace('value="0.63 0.065 0.05"',
                             'value="0.1 0.1 0.8"'))
    os.utime(live, (time.time() + 5, time.time() + 5))
    sh.check_reload()
    assert sh.scene is not old
    assert not torch.equal(sh.scene.bsdfs.refl, old.bsdfs.refl)
    assert sh.actor._pending_scene is sh.scene
    with open(live, "w") as f:
        f.write("<scene")
    os.utime(live, (time.time() + 9, time.time() + 9))
    kept = sh.scene
    sh.check_reload()  # a broken edit keeps the running scene
    assert sh.scene is kept


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple, np.ndarray)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b, (a, b)


def test_configurator_matches_reference():
    """Every category's plugins and parameter schemas, and a staged change
    set applied, as the reference's."""
    for cat in CATEGORIES:
        _same(conf.describe_category(cat), jconf.describe_category(cat))
    assert "path" in conf.describe_category("integrator")
    assert conf.extract_parameters("integrator", "path")["maxDepth"] == {
        "type": "int", "default": -1}
    from mitsuba_im_tpu.scene.build import RenderSettings as JSettings
    from mitsuba_im_tpu_torch.render.job import RenderSettings

    out = []
    for mod, st in ((conf, RenderSettings()), (jconf, JSettings())):
        c = mod.SceneConfigurator(st)
        c.stage_integrator("path", maxDepth=3, rrDepth=5)
        c.stage_sampler("ldsampler", sampleCount=8)
        c.stage_rfilter("gaussian")
        diff = c.diff()
        recorded = []
        actor = type("A", (), {"update_settings": recorded.append})()
        s = c.apply(actor)
        assert recorded == [s] and c.changes.empty()
        out.append((diff, {k: getattr(s, k) for k in (
            "integrator", "integrator_props", "sampler", "spp", "rfilter",
            "rfilter_radius")}))
    _same(out[0], out[1])
    assert out[0][0]["integrator"] == {"name": "path", "maxDepth": 3}


def test_animated_transform_and_motion_image():
    """eval at keys, between them and outside, bit for bit; the motion
    integrator's previous pose from a sensor animation (prev =
    anim.eval(-time_delta)), the port's image against the reference's."""
    keys = [Transform.translate([0.0, 0.0, 0.0]),
            Transform.translate([0.2, 0.1, -0.3]) @ Transform.rotate(
                [0, 1, 0], 25.0) @ Transform.scale([1.0, 1.5, 1.0]),
            Transform.translate([0.4, 0.3, 0.2]) @ Transform.rotate(
                [1, 1, 0], -40.0)]
    anim = track.AnimatedTransform([-0.1, 0.0, 0.5], keys)
    janim = jtrack.AnimatedTransform([-0.1, 0.0, 0.5],
                                     [JTransform(k.m) for k in keys])
    for t in (-1.0, -0.1, -0.05, -1 / 24, 0.0, 0.2, 0.5, 2.0):
        np.testing.assert_array_equal(anim.eval(t).m, janim.eval(t).m)
    assert not anim.static and track.AnimatedTransform([0], keys[:1]).static
    tr = track.AnimationTrack([0.0, 1.0], [[0, 0], [2, 4]])
    np.testing.assert_array_equal(tr.eval(0.25), [0.5, 1.0])

    jscene, jsettings = jax_cornell()
    jsettings = copy.copy(jsettings)  # the cached scene's stay as they are
    scene, settings = tiny_cornell("cpu")
    cam = [scene.sensor.to_world.numpy().astype(np.float64)]
    cam.append(cam[0] @ Transform.translate([0.1, -0.05, 0.2]).m)
    anim = track.AnimatedTransform([-0.5, 0.0], [Transform(m) for m in cam])
    janim = jtrack.AnimatedTransform([-0.5, 0.0],
                                     [JTransform(m) for m in cam])
    for st, a in ((settings, anim), (jsettings, janim)):
        st.width = st.height = RES
        st.spp = 1
        st.integrator = "motion"
        st.integrator_props = {"sensor_animation": a, "time_delta": 0.25}
    img = develop(render_film(scene, settings)).numpy()
    jimg = np.asarray(jjob.develop(jjob.render_film(jscene, jsettings)))
    np.testing.assert_allclose(img, jimg, rtol=1e-5, atol=1e-4)
    assert np.abs(img[..., :2]).max() > 0.1


def test_shell_entry_point_in_a_pty(xml_cornell):
    """``python -m mitsuba_im_tpu_torch.interactive scene.xml --device
    cpu`` on a pseudo-terminal: it draws half-block frames until ``q``,
    then restores the terminal and exits 0."""
    import pty
    import select
    import subprocess
    import sys

    master, slave = pty.openpty()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mitsuba_im_tpu_torch.interactive",
         xml_cornell, "--device", "cpu"], stdin=slave, stdout=slave,
        stderr=subprocess.PIPE, cwd=root,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    os.close(slave)
    out = b""
    deadline = time.time() + 60
    try:
        while "▀".encode() not in out:
            assert time.time() < deadline and proc.poll() is None, out[-200:]
            if select.select([master], [], [], 0.1)[0]:
                out += os.read(master, 1 << 16)
        os.write(master, b"q")
        while True:  # drain the frames: a full pty would block the shell
            if select.select([master], [], [], 0.1)[0]:
                try:
                    out += os.read(master, 1 << 16)
                except OSError:  # the shell has closed its side
                    break
            elif proc.poll() is not None:
                break
            assert time.time() < deadline + 30, "the shell did not quit"
        assert proc.wait(timeout=30) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
        os.close(master)
    text = out.decode(errors="replace")
    assert "\x1b[2J\x1b[?25l" in text and " spp | gen " in text
    assert text.rstrip().endswith("\x1b[?25h\x1b[0m")
