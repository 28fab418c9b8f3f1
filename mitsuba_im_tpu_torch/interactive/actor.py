"""Responsive progressive rendering (``mitsuba_im_tpu/interactive/actor.py``;
Mitsuba IM's ``InteractiveSceneProcess`` and ``ResponsiveIntegrator``).

- The unit of cooperative scheduling is one pass of one sample per pixel
  (``render/job.py::render_pass``): the host checks the control flags
  between passes (Mitsuba IM polls ``Controls{continu, abort,
  interrupt}`` every 64 samples).
- A scene or settings change restarts accumulation: first one preview
  pass at ``1 / preview_scale`` of the resolution through the box filter
  of radius 0.5 (the reference's actor.py:180-188), then passes at full
  resolution into a fresh film.
- Film revisions carry a generation that rises with every revision.
- The counter-based sampler never runs out: passes go on with new sample
  indices.
- Pause waits on a condition variable.

After k full-resolution passes the film is ``render_film``'s k-spp film
bit for bit wherever the pass's splat is deterministic (every filter on
the CPU; the box filter on the card) and the sampler ignores the call's
``spp`` (the independent sampler).  Each pass's time is taken after the
card's stream has finished it, so ``pass_times`` are the card's.
"""
from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..film.film import F_BOX, develop, make_film
from ..render.job import (RenderSettings, integrator_fn, render_pass,
                          sampler_kind)
from ..scene.scene import Scene


@dataclass
class Controls:
    """Cooperative control block (Mitsuba IM's ``integrator2.h``)."""

    continu: bool = True
    abort: bool = False
    paused: bool = False


@dataclass
class FilmRevision:
    image: np.ndarray
    spp: int
    generation: int
    resolution_scale: int  # 1 = full resolution; > 1 = preview


class RenderActor:
    """Background progressive renderer with live scene and camera
    updates."""

    def __init__(self, scene: Scene, settings: RenderSettings,
                 preview_scale: int = 4, max_spp: int | None = None):
        self.settings = settings
        self.preview_scale = preview_scale
        self.max_spp = max_spp
        self.controls = Controls()
        self._scene = scene
        self._pending_scene: Scene | None = None
        self._pending_settings: RenderSettings | None = None
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._revision: FilmRevision | None = None
        self._generation = 0
        self._thread: threading.Thread | None = None
        self.spp_done = 0
        self.pass_times: list[float] = []
        self.error: BaseException | None = None
        # set while the render thread waits out a pause (no pass in flight)
        self.parked = threading.Event()

    # -- control surface (the UI thread) -------------------------------------
    def update_scene(self, scene: Scene):
        """Queue a scene or camera change; it takes effect at the next pass
        boundary."""
        with self._lock:
            self._pending_scene = scene

    def update_settings(self, settings: RenderSettings):
        """Queue a settings swap (integrator, sampler or film: the
        configurator's ``Changes::apply``); accumulation restarts at the
        next pass boundary."""
        with self._lock:
            self._pending_settings = settings

    def pause(self, value: bool = True):
        with self._cv:
            self.controls.paused = value
            self._cv.notify_all()

    def stop(self):
        with self._cv:
            self.controls.abort = True
            self.controls.paused = False
            self._cv.notify_all()
        if self._thread:
            self._thread.join(timeout=30)

    def latest(self) -> FilmRevision | None:
        with self._lock:
            return self._revision

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    # -- render loop ---------------------------------------------------------
    def _publish(self, film, spp, scale):
        img = develop(film).cpu().numpy()
        with self._lock:
            self._generation += 1
            self._revision = FilmRevision(img, spp, self._generation, scale)

    def _settings_at(self, scale: int) -> RenderSettings:
        s = copy.copy(self.settings)
        s.width = max(self.settings.width // scale, 8)
        s.height = max(self.settings.height // scale, 8)
        return s

    def _run(self):
        try:
            with torch.no_grad():
                self._loop()
        except BaseException as e:  # the render thread's boundary
            self.error = e
            raise

    def _loop(self):
        scene = self._scene
        restart = True
        film = None
        while not self.controls.abort:
            with self._cv:
                while self.controls.paused and not self.controls.abort:
                    self.parked.set()
                    self._cv.wait()
                self.parked.clear()
                if self._pending_scene is not None:
                    scene = self._pending_scene
                    self._pending_scene = None
                    restart = True
                if self._pending_settings is not None:
                    self.settings = self._pending_settings
                    self._pending_settings = None
                    restart = True
            if self.controls.abort:
                break

            if restart:
                # the preview pass at reduced resolution first
                s_prev = self._settings_at(self.preview_scale)
                film_prev = self._one_pass_film(scene, s_prev, 0)
                self._publish(film_prev, 1, self.preview_scale)
                film = make_film(self.settings.width, self.settings.height,
                                 self.settings.rfilter,
                                 self.settings.rfilter_radius,
                                 device=scene.device)
                self.spp_done = 0
                restart = False
                continue

            t0 = time.perf_counter()
            film = self._accumulate_pass(scene, film, self.spp_done)
            if film.data.is_cuda:
                torch.cuda.current_stream(film.data.device).synchronize()
            self.pass_times.append(time.perf_counter() - t0)
            self.spp_done += 1
            self._publish(film, self.spp_done, 1)
            if self.max_spp is not None and self.spp_done >= self.max_spp:
                break

    def _li_fn(self):
        return integrator_fn(self.settings)

    def _accumulate_pass(self, scene, film, sample_idx):
        s = self.settings
        return render_pass(scene, film, sample_idx, s.seed, self._li_fn(),
                           sampler_kind(s), max(s.spp, 1))

    def _one_pass_film(self, scene, s: RenderSettings, sample_idx):
        film = make_film(s.width, s.height, F_BOX, 0.5, device=scene.device)
        return render_pass(scene, film, sample_idx, s.seed, self._li_fn(),
                           sampler_kind(s), 1)
