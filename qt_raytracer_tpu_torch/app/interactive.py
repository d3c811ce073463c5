"""Interactive progressive viewer — the L6 control loop, terminal-native
(counterpart of ``qt_raytracer_tpu.app.interactive``).

The reference's UI layer (resources/qml/Main.qml) is a live control loop:
the user edits parameters / starts / stops, the viewport refines
progressively, stats update per frame (RayTracerFboItem.cpp:429-515).
app/preview.py is the display half; this module is the CONTROL half,
without any UI toolkit: a raw-mode terminal loop with

  - camera flight (the thing a fixed-camera Qt panel never had):
    w/s dolly, a/d strafe, r/f up/down, i/k pitch, j/l yaw,
    +/- vfov zoom, [/] aperture, ,/. focus distance, 0 reset;
  - progressive refinement whenever the camera is idle (1-spp steps,
    running-mean accumulation — same ProgressiveRenderer the batch path
    checkpoints), reset-on-move exactly like the GPU backends'
    resetAccumulation (GpuPathTracer.cpp:85-95);
  - p saves the current accumulation as PNG, q/ESC quits;
  - a stats HUD line (Msamples/s formula of RayTracerFboItem.cpp:400-404).

The controller (InteractiveViewer) is pure logic — tests drive it with a
scripted key stream (tests/test_torch_interactive.py); run_interactive()
owns the termios/select plumbing and needs a real TTY. The camera is built
on the device of the scene the viewer renders.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch

from ..core.camera import Camera, make_camera
from ..core.config import RenderConfig
from .png import write_png
from .preview import ansi_frame
from .progressive import ProgressiveRenderer
from .stats import RenderStats, Timer, synchronize


@dataclasses.dataclass
class CameraRig:
    """Mutable flight-model state, convertible to/from the Camera.

    Orientation is (yaw, pitch) of the LOOK direction (radians; yaw about
    +y from +x toward +z), which composes keyboard increments cleanly and
    cannot drift off-orthonormal the way incremental basis updates do.
    ``device`` is where camera() builds (None: the CUDA card).
    """

    lookfrom: np.ndarray        # [3] f32
    yaw: float
    pitch: float
    vfov: float                 # degrees
    aspect_ratio: float
    aperture: float
    focus_dist: float
    vup: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    device: torch.device | str | None = None

    def forward(self) -> np.ndarray:
        cp = math.cos(self.pitch)
        return np.array([cp * math.cos(self.yaw), math.sin(self.pitch),
                         cp * math.sin(self.yaw)], np.float32)

    def camera(self) -> Camera:
        return make_camera(
            lookfrom=self.lookfrom,
            lookat=self.lookfrom + self.forward(),
            vup=self.vup, vfov=self.vfov, aspect_ratio=self.aspect_ratio,
            aperture=self.aperture, focus_dist=self.focus_dist,
            device=self.device)


def rig_from_camera(camera: Camera, aspect_ratio: float) -> CameraRig:
    """Recover flight state from a built Camera (every stored field of the
    reference camera model is invertible: RayTracer.h:545-561). The rig
    builds its cameras on this camera's device."""
    field = lambda name: getattr(camera, name).cpu().numpy().astype(
        np.float64)
    origin = field("origin")
    f = -field("w")                                 # w: unit, backward
    # lower_left_corner = origin - h/2 - v/2 - focus_dist * w
    focus_vec = (origin - field("lower_left_corner")
                 - field("horizontal") / 2.0 - field("vertical") / 2.0)
    focus_dist = float(np.linalg.norm(focus_vec))
    viewport_h = float(np.linalg.norm(field("vertical"))) / focus_dist
    vfov = math.degrees(2.0 * math.atan(viewport_h / 2.0))
    return CameraRig(
        lookfrom=origin.astype(np.float32),
        yaw=math.atan2(f[2], f[0]),
        pitch=math.asin(max(-1.0, min(1.0, f[1]))),
        vfov=vfov,
        aspect_ratio=aspect_ratio,
        aperture=2.0 * float(field("lens_radius")),
        focus_dist=focus_dist,
        device=camera.device,
    )


class InteractiveViewer:
    """Key-driven controller around a ProgressiveRenderer.

    handle_key() mutates the rig and flags the accumulation dirty;
    step() rebuilds the camera if dirty (reset-on-move) and traces one
    more progressive batch; frame() renders the ANSI viewport + HUD.
    """

    MOVE_KEYS = {
        "w": (+1, 0, 0), "s": (-1, 0, 0),     # dolly along look
        "d": (0, +1, 0), "a": (0, -1, 0),     # strafe along right
        "r": (0, 0, +1), "f": (0, 0, -1),     # world up/down
    }
    TURN = math.radians(5.0)
    PITCH_MAX = math.radians(88.0)

    def __init__(self, scene, camera: Camera, cfg: RenderConfig,
                 seed: int = 0, batch: int = 1, max_spp: int = 0,
                 move_speed: float = 0.0):
        self.cfg = cfg
        self.batch = batch
        self.max_spp = max_spp or cfg.spp
        self.rig = rig_from_camera(camera, float(cfg.aspect_ratio))
        self.home = dataclasses.replace(
            self.rig, lookfrom=self.rig.lookfrom.copy())
        # Default flight speed scales with the framing distance so the same
        # keys feel right in the book-cover scene and the terrain.
        self.move_speed = move_speed or 0.08 * self.rig.focus_dist
        self.renderer = ProgressiveRenderer(scene, self.rig.camera(), cfg,
                                            seed=seed)
        self.dirty = False
        self.saved_path: str | None = None
        self.timer = Timer()
        self.steps = 0

    # ---------------------------------------------------------------- input
    def handle_key(self, ch: str) -> str:
        """Apply one key. Returns 'quit' | 'moved' | 'saved' | 'noop'."""
        if ch in ("q", "\x1b"):
            return "quit"
        if ch in self.MOVE_KEYS:
            dolly, strafe, lift = self.MOVE_KEYS[ch]
            f = self.rig.forward()
            right = np.cross(f, self.rig.vup)
            n = np.linalg.norm(right)
            right = right / n if n > 1e-8 else np.array([1, 0, 0], np.float32)
            delta = (dolly * f + strafe * right
                     + lift * self.rig.vup) * self.move_speed
            self.rig.lookfrom = (self.rig.lookfrom
                                 + delta.astype(np.float32))
        elif ch == "j":
            self.rig.yaw -= self.TURN
        elif ch == "l":
            self.rig.yaw += self.TURN
        elif ch == "i":
            self.rig.pitch = min(self.rig.pitch + self.TURN, self.PITCH_MAX)
        elif ch == "k":
            self.rig.pitch = max(self.rig.pitch - self.TURN, -self.PITCH_MAX)
        elif ch in ("+", "="):
            self.rig.vfov = max(5.0, self.rig.vfov - 2.0)    # zoom in
        elif ch == "-":
            self.rig.vfov = min(120.0, self.rig.vfov + 2.0)
        elif ch == "[":
            self.rig.aperture = max(0.0, self.rig.aperture - 0.02)
        elif ch == "]":
            self.rig.aperture += 0.02
        elif ch == ",":
            self.rig.focus_dist = max(0.1, self.rig.focus_dist * 0.95)
        elif ch == ".":
            self.rig.focus_dist *= 1.05
        elif ch == "0":
            self.rig = dataclasses.replace(
                self.home, lookfrom=self.home.lookfrom.copy())
        elif ch == "p":
            self.saved_path = f"interactive_{int(time.time())}.png"
            write_png(self.saved_path, self.renderer.image())
            return "saved"
        else:
            return "noop"
        self.dirty = True
        return "moved"

    # ------------------------------------------------------------- progress
    def step(self) -> bool:
        """Advance refinement; returns True if a new frame was traced."""
        if self.dirty:
            # resetAccumulation analog: camera changed, restart the mean.
            self.renderer.camera = self.rig.camera()
            self.renderer.reset()
            self.dirty = False
        if self.renderer.frame_index >= self.max_spp:
            return False
        self.renderer.step(min(self.batch,
                               self.max_spp - self.renderer.frame_index))
        self.steps += 1
        return True

    # -------------------------------------------------------------- display
    def hud(self) -> str:
        spp = self.renderer.frame_index
        synchronize(self.renderer.device)
        stats = RenderStats(self.cfg.width, self.cfg.height, max(spp, 1),
                            self.cfg.max_depth, self.timer.elapsed_s,
                            frames=max(self.steps, 1),
                            backend=self.renderer.device.type)
        p = self.rig.lookfrom
        return (f"[{spp}/{self.max_spp} spp] "
                f"pos ({p[0]:.2f},{p[1]:.2f},{p[2]:.2f}) "
                f"vfov {self.rig.vfov:.0f} ap {self.rig.aperture:.2f} | "
                f"{stats.text()} | wasd/rf move ijkl look +- zoom "
                f"[] ap ,. focus 0 home p png q quit")

    def frame(self, cols: int = 100) -> str:
        return ansi_frame(self.renderer.image(), cols) + "\n" + self.hud()


def run_interactive(scene, camera: Camera, cfg: RenderConfig, seed: int = 0,
                    batch: int = 1, ansi_cols: int = 100) -> int:
    """Raw-mode terminal loop: refine while idle, react to keys instantly."""
    import select
    import termios
    import tty

    if not sys.stdin.isatty():
        print("interactive mode needs a TTY (use `preview --ansi` for "
              "non-interactive live output)", file=sys.stderr)
        return 2

    viewer = InteractiveViewer(scene, camera, cfg, seed=seed, batch=batch)
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        sys.stderr.write("\x1b[?25l")            # hide cursor
        redraw = True
        while True:
            # Read the descriptor itself: sys.stdin's buffer can take keys
            # that select() then no longer reports, so they would wait for
            # the next key press.
            while select.select([fd], [], [], 0)[0]:
                keys = os.read(fd, 1024).decode("utf-8", "replace")
                if not keys:                     # end of input
                    return 0
                for ch in keys:
                    res = viewer.handle_key(ch)
                    if res == "quit":
                        return 0
                    if res == "saved":
                        sys.stderr.write(f"\nsaved {viewer.saved_path}\n")
                    redraw = redraw or res == "moved"
            if viewer.step() or redraw:
                sys.stderr.write("\x1b[H\x1b[2J" + viewer.frame(ansi_cols)
                                 + "\n")
                sys.stderr.flush()
                redraw = False
            else:
                # Fully converged: block briefly on input instead of spinning.
                select.select([fd], [], [], 0.1)
    finally:
        sys.stderr.write("\x1b[?25h\x1b[0m\n")
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
