"""Interactive terminal front end (``mitsuba_im_tpu/interactive/shell.py``;
Mitsuba IM's ``shell.cpp``, an imgui/GLFW app with a fly camera, a live
preview and hot reload).

Without a GL stack the live preview is drawn into the terminal: each
character cell shows two pixels through the U+2580 upper half block with
24-bit foreground and background colours, so a 200 x 50 terminal is a
200 x 100 viewport.  The keys:

  W/A/S/D/E/C   fly the camera (Mitsuba IM's InteractiveSensor)
  arrow keys    look around
  p             pause or resume
  r             restart accumulation
  [ / ]         exposure down / up
  o             write a snapshot EXR next to the scene file
  q / Ctrl-C    quit

The render runs in a ``RenderActor`` (progressive film revisions with
generations, a reduced-resolution restart on motion); the shell is a thin
present and input loop.  The scene file's mtime is polled and the scene
rebuilt when it changes.

    python -m mitsuba_im_tpu_torch.interactive scene.xml [--device cpu]

renders on the card unless the CPU is asked for.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import select
import sys
import time

import numpy as np

from ..core.transform import Transform
from ..core.types import host_tensor
from .actor import RenderActor


# ---------------------------------------------------------------------------
# Camera state (InteractiveSensor analog)
# ---------------------------------------------------------------------------

class FlyCamera:
    """Yaw/pitch/position state derived from (and rebuilt into) the
    sensor's to_world transform."""

    def __init__(self, to_world: np.ndarray):
        m = np.asarray(to_world, np.float64)
        self.pos = m[:3, 3].copy()
        fwd = m[:3, 2] / np.linalg.norm(m[:3, 2])
        self.yaw = float(np.arctan2(fwd[0], fwd[2]))
        self.pitch = float(np.arcsin(np.clip(fwd[1], -1.0, 1.0)))

    def forward(self) -> np.ndarray:
        cp = np.cos(self.pitch)
        return np.asarray([np.sin(self.yaw) * cp, np.sin(self.pitch),
                           np.cos(self.yaw) * cp])

    def right(self) -> np.ndarray:
        f = self.forward()
        r = np.cross(f, [0.0, 1.0, 0.0])
        n = np.linalg.norm(r)
        return r / n if n > 1e-9 else np.asarray([1.0, 0.0, 0.0])

    def move(self, dx=0.0, dy=0.0, dz=0.0, speed=0.15):
        self.pos += (self.right() * dx + np.asarray([0.0, 1.0, 0.0]) * dy
                     + self.forward() * dz) * speed

    def look(self, dyaw=0.0, dpitch=0.0, speed=0.08):
        self.yaw += dyaw * speed
        self.pitch = float(np.clip(self.pitch + dpitch * speed,
                                   -1.45, 1.45))

    def to_world(self) -> Transform:
        return Transform.look_at(self.pos, self.pos + self.forward(),
                                 [0.0, 1.0, 0.0])


# ---------------------------------------------------------------------------
# ANSI half-block presenter (StackedPreview blit analog)
# ---------------------------------------------------------------------------

def _srgb8(img: np.ndarray, exposure: float) -> np.ndarray:
    x = np.clip(img * exposure, 0.0, None)
    s = np.where(x <= 0.0031308, 12.92 * x,
                 1.055 * np.power(x, 1.0 / 2.4) - 0.055)
    return np.clip(s * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


def _downsample(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-index resample to (h, w, 3) — cheap and artifact-free
    enough for a live preview."""
    ys = np.linspace(0, img.shape[0] - 1, h).round().astype(int)
    xs = np.linspace(0, img.shape[1] - 1, w).round().astype(int)
    return img[ys][:, xs]


def frame_to_ansi(img: np.ndarray, cols: int, rows: int,
                  exposure: float = 1.0, status: str = "") -> str:
    """Render an HDR image to an ANSI truecolor half-block frame."""
    h = max(2, (rows - 1) * 2)  # one text row per two pixel rows
    w = max(2, cols)
    pix = _srgb8(_downsample(img, h, w), exposure)
    out = ["\x1b[H"]
    for y in range(0, h - 1, 2):
        row = []
        top, bot = pix[y], pix[y + 1]
        for x in range(w):
            tr, tg, tb = top[x]
            br, bg_, bb = bot[x]
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                       f"\x1b[48;2;{br};{bg_};{bb}m▀")
        out.append("".join(row) + "\x1b[0m\n")
    out.append("\x1b[0m\x1b[K" + status[:cols])
    return "".join(out)


# ---------------------------------------------------------------------------
# Shell
# ---------------------------------------------------------------------------

class TerminalShell:
    """Present/input loop over a RenderActor.  Testable headless: call
    :meth:`handle_key` + :meth:`render_frame` directly."""

    def __init__(self, scene, settings, scene_path: str | None = None,
                 preview_scale: int = 4):
        self.scene = scene
        self.settings = settings
        self.scene_path = scene_path
        self._mtime = (os.path.getmtime(scene_path)
                       if scene_path and os.path.exists(scene_path) else 0)
        self.exposure = 1.0
        self.camera = FlyCamera(scene.sensor.to_world.cpu().numpy())
        self.actor = RenderActor(scene, settings,
                                 preview_scale=preview_scale)
        self.quit = False
        self._dirty_cam = False

    # -- input ------------------------------------------------------------

    MOVES = {"w": (0, 0, 1), "s": (0, 0, -1), "a": (-1, 0, 0),
             "d": (1, 0, 0), "q": None, "e": (0, 1, 0), "c": (0, -1, 0)}
    LOOKS = {"UP": (0, 1), "DOWN": (0, -1), "LEFT": (1, 0),
             "RIGHT": (-1, 0)}

    def handle_key(self, key: str):
        if key in ("q", "\x03"):
            self.quit = True
        elif key == "p":
            self.actor.pause(not self.actor.controls.paused)
        elif key == "r":
            self.actor.update_scene(self.scene)  # forces a restart
        elif key == "[":
            self.exposure /= 1.4
        elif key == "]":
            self.exposure *= 1.4
        elif key == "o":
            self._snapshot()
        elif key in self.MOVES and self.MOVES[key] is not None:
            dx, dy, dz = self.MOVES[key]
            self.camera.move(dx, dy, dz)
            self._dirty_cam = True
        elif key in self.LOOKS:
            dyaw, dpitch = self.LOOKS[key]
            self.camera.look(dyaw, dpitch)
            self._dirty_cam = True

    def flush_camera(self):
        if not self._dirty_cam:
            return
        self._dirty_cam = False
        t = self.camera.to_world()
        dev = self.scene.device
        self.scene = dataclasses.replace(
            self.scene, sensor=dataclasses.replace(
                self.scene.sensor, to_world=host_tensor(t.m, np.float32, dev),
                to_camera=host_tensor(t.inv, np.float32, dev)))
        self.actor.update_scene(self.scene)

    def check_reload(self):
        """shell.cpp:322-324 — poll the scene file for changes."""
        if not self.scene_path:
            return
        try:
            mt = os.path.getmtime(self.scene_path)
        except OSError:
            return
        if mt != self._mtime:
            self._mtime = mt
            from ..scene.xml import load_scene
            try:
                scene, settings = load_scene(self.scene_path,
                                             device=self.scene.device)
            except Exception as e:  # keep running on broken edits
                sys.stderr.write(f"\n[reload] failed: {e}\n")
                return
            settings.width = self.settings.width
            settings.height = self.settings.height
            self.scene, self.settings = scene, settings
            self.camera = FlyCamera(scene.sensor.to_world.cpu().numpy())
            self.actor.update_scene(scene)

    def _snapshot(self):
        rev = self.actor.latest()
        if rev is None:
            return
        from ..io.exr import write_exr
        base = os.path.splitext(self.scene_path or "interactive")[0]
        path = f"{base}_snapshot.exr"
        write_exr(path, np.asarray(rev.image))
        sys.stderr.write(f"\n[snapshot] {path}\n")

    # -- present ----------------------------------------------------------

    def render_frame(self, cols: int, rows: int) -> str:
        rev = self.actor.latest()
        if rev is None:
            return "\x1b[H waiting for first pass..."
        st = (f" {rev.spp} spp | gen {rev.generation} "
              f"| 1/{rev.resolution_scale} res "
              f"| exp {self.exposure:.2f} "
              f"| {'PAUSED' if self.actor.controls.paused else 'render'} "
              f"| WASD move, arrows look, p pause, o snap, q quit")
        return frame_to_ansi(rev.image, cols, rows, self.exposure, st)

    # -- tty loop ---------------------------------------------------------

    def run(self):
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        self.actor.start()
        sys.stdout.write("\x1b[2J\x1b[?25l")  # clear, hide cursor
        try:
            tty.setcbreak(fd)
            last_check = 0.0
            while not self.quit:
                r, _, _ = select.select([fd], [], [], 0.05)
                while r:
                    key = self._read_key(fd)
                    if key:
                        self.handle_key(key)
                    r, _, _ = select.select([fd], [], [], 0.0)
                self.flush_camera()
                now = time.time()
                if now - last_check > 1.0:
                    last_check = now
                    self.check_reload()
                try:
                    size = os.get_terminal_size()
                    cols, rows = size.columns, size.lines
                except OSError:
                    cols = rows = 0
                if cols < 8 or rows < 4:  # degenerate/unset pty winsize
                    cols, rows = 80, 24
                sys.stdout.write(self.render_frame(cols, rows))
                sys.stdout.flush()
        finally:
            self.actor.stop()
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
            sys.stdout.write("\x1b[?25h\x1b[0m\n")

    @staticmethod
    def _read_key(fd) -> str:
        ch = os.read(fd, 1).decode(errors="replace")
        if ch != "\x1b":
            return ch
        # arrow keys: ESC [ A/B/C/D
        seq = os.read(fd, 2).decode(errors="replace")
        return {"[A": "UP", "[B": "DOWN", "[C": "RIGHT",
                "[D": "LEFT"}.get(seq, "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mitsuba_im_tpu_torch.interactive",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scene", help="scene XML file")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    from ..scene.xml import load_scene

    scene, settings = load_scene(args.scene, device=args.device)
    shell = TerminalShell(scene, settings, scene_path=args.scene)
    shell.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
