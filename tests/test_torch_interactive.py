"""The port's interactive viewer controller on the CPU (no TTY: the key
stream is scripted), the cases of tests/test_interactive.py, and its rig
held against the JAX package's on the same camera and keys; plus the real
raw-mode loop of ``run_interactive`` under a pty.

Tolerances: rig round trips within rtol 1e-5, atol 1e-6 (f32 camera
fields, as in tests/test_interactive.py); the port's rig against JAX's:
angles and distances within 1e-6, positions within 1e-5; images after a
move equal a fresh progressive render bit for bit.
"""

import os
import select
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from qt_raytracer_tpu.app.interactive import InteractiveViewer as JViewer
from qt_raytracer_tpu.app.interactive import rig_from_camera as j_rig_from_camera
from qt_raytracer_tpu.core.config import RenderConfig as JConfig
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu_torch import RenderConfig, scenes
from qt_raytracer_tpu_torch.app.interactive import (InteractiveViewer,
                                                    run_interactive,
                                                    rig_from_camera)
from qt_raytracer_tpu_torch.app.progressive import ProgressiveRenderer
from qt_raytracer_tpu_torch.utils.convert import camera_from_arrays
from torch_helpers import _one_thread  # noqa: F401

FIELDS = ("origin", "lower_left_corner", "horizontal", "vertical", "u", "v",
          "w", "lens_radius")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's (see test_torch_edge.py).
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


@pytest.fixture(scope="module")
def setup():
    cfg = RenderConfig(width=64, height=36, spp=4, max_depth=3)
    scene, camera = scenes.get_scene("three_sphere", cfg.aspect_ratio,
                                     device="cpu")
    return cfg, scene, camera


def test_rig_roundtrip(setup):
    # Every stored Camera field survives rig extraction + rebuild, on the
    # camera's device.
    cfg, scene, camera = setup
    rig = rig_from_camera(camera, float(cfg.aspect_ratio))
    rebuilt = rig.camera()
    assert rebuilt.device == camera.device
    for field in FIELDS:
        torch.testing.assert_close(getattr(rebuilt, field),
                                   getattr(camera, field),
                                   rtol=1e-5, atol=1e-6, msg=field)


def _rig_state(rig):
    return (np.asarray(rig.lookfrom, np.float64),
            np.array([rig.yaw, rig.pitch, rig.vfov, rig.aspect_ratio,
                      rig.aperture, rig.focus_dist]))


@pytest.mark.parametrize("name", ["three_sphere", "random", "cornell"])
def test_rig_and_keys_match_jax(name):
    # The same camera gives the same rig in both packages, and the same key
    # stream moves both rigs alike; the cameras they build agree.
    cfg = RenderConfig(width=32, height=18, spp=2, max_depth=2)
    _, jcam = jscenes.get_scene(name, cfg.aspect_ratio)
    cam = camera_from_arrays({f: np.asarray(getattr(jcam, f))
                              for f in FIELDS}, device="cpu")
    jr = j_rig_from_camera(jcam, float(cfg.aspect_ratio))
    r = rig_from_camera(cam, float(cfg.aspect_ratio))
    for a, b in zip(_rig_state(r), _rig_state(jr)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)

    scene = scenes.get_scene(name, cfg.aspect_ratio, device="cpu")[0]
    jscene = jscenes.get_scene(name, cfg.aspect_ratio)[0]
    v = InteractiveViewer(scene, cam, cfg)
    jv = JViewer(jscene, jcam, JConfig(width=32, height=18, spp=2,
                                       max_depth=2))
    for ch in "wwadrfjliik+-=[]],.?0sdl":
        assert v.handle_key(ch) == jv.handle_key(ch), ch
        (p, a), (jp, ja) = _rig_state(v.rig), _rig_state(jv.rig)
        np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-5, err_msg=ch)
        np.testing.assert_allclose(a, ja, rtol=1e-6, atol=1e-6, err_msg=ch)
    built, jbuilt = v.rig.camera(), jv.rig.camera()
    for field in FIELDS:
        np.testing.assert_allclose(getattr(built, field).numpy(),
                                   np.asarray(getattr(jbuilt, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)


def test_move_resets_and_idle_accumulates(setup):
    cfg, scene, camera = setup
    v = InteractiveViewer(scene, camera, cfg, seed=0)
    assert v.step() and v.renderer.frame_index == 1
    assert v.step() and v.renderer.frame_index == 2

    before = v.rig.lookfrom.copy()
    assert v.handle_key("w") == "moved"
    assert not np.allclose(v.rig.lookfrom, before)
    assert v.step()                       # reset-on-move, then 1 fresh spp
    assert v.renderer.frame_index == 1

    # Idle refinement runs to max_spp, then step() reports converged.
    while v.step():
        pass
    assert v.renderer.frame_index == cfg.spp
    assert not v.step()


def test_turn_zoom_home_quit(setup):
    cfg, scene, camera = setup
    v = InteractiveViewer(scene, camera, cfg)
    yaw0, vfov0 = v.rig.yaw, v.rig.vfov
    assert v.handle_key("j") == "moved" and v.rig.yaw < yaw0
    assert v.handle_key("+") == "moved" and v.rig.vfov < vfov0
    assert v.handle_key("]") == "moved" and v.rig.aperture > 0
    assert v.handle_key("0") == "moved"
    assert v.rig.yaw == pytest.approx(yaw0)
    assert v.rig.vfov == pytest.approx(vfov0)
    assert v.handle_key("?") == "noop"
    assert v.handle_key("q") == "quit"
    assert v.handle_key("\x1b") == "quit"


def test_frame_renders_ansi_hud(setup):
    cfg, scene, camera = setup
    v = InteractiveViewer(scene, camera, cfg)
    v.step()
    out = v.frame(cols=40)
    assert "\x1b[38;2;" in out            # truecolor viewport
    assert "spp" in out and "Msamples/s" in out and "Backend cpu" in out


def test_save_key_writes_the_image(setup, tmp_path, monkeypatch):
    cfg, scene, camera = setup
    monkeypatch.chdir(tmp_path)
    v = InteractiveViewer(scene, camera, cfg)
    v.step()
    assert v.handle_key("p") == "saved" and not v.dirty
    with Image.open(tmp_path / v.saved_path) as im:
        np.testing.assert_array_equal(np.asarray(im), v.renderer.image())


def test_mesh_world_controller_smoke():
    # The viewer drives mesh worlds, not just SphereScenes (rig extraction,
    # reset-on-move, ANSI frame) on the true Cornell box.
    cfg = RenderConfig(width=32, height=18, spp=2, max_depth=2)
    scene, camera = scenes.get_scene("cornell_mesh", cfg.aspect_ratio,
                                     device="cpu")
    v = InteractiveViewer(scene, camera, cfg, seed=1)
    assert v.step() and v.renderer.frame_index == 1
    assert v.handle_key("w") == "moved"
    assert v.step() and v.renderer.frame_index == 1   # reset-on-move
    out = v.frame(cols=24)
    assert "\x1b[38;2;" in out and "spp" in out
    img = v.renderer.image()
    assert np.isfinite(img).all() and img.max() > 0


def test_move_matches_fresh_render(setup):
    # After flying somewhere, the accumulation equals a from-scratch
    # progressive render with the same camera and seed (no stale state).
    cfg, scene, camera = setup
    v = InteractiveViewer(scene, camera, cfg, seed=3)
    v.step()
    for ch in "wwjli":
        v.handle_key(ch)
    v.step()
    v.step()

    fresh = ProgressiveRenderer(scene, v.rig.camera(), cfg, seed=3)
    fresh.step(1)
    fresh.step(1)
    assert torch.equal(v.renderer.state.accum, fresh.state.accum)
    np.testing.assert_array_equal(v.renderer.image(), fresh.image())


def test_run_interactive_needs_a_tty(setup, monkeypatch, capsys):
    cfg, scene, camera = setup
    monkeypatch.setattr(sys, "stdin", open(os.devnull))
    try:
        assert run_interactive(scene, camera, cfg) == 2
    finally:
        sys.stdin.close()
    assert "TTY" in capsys.readouterr().err


def test_run_interactive_termios_loop_under_pty():
    # The real raw-mode loop (termios/select plumbing) on the CPU: drive the
    # CLI's interactive command inside a pty, let it draw an ANSI frame,
    # send a movement key and 'q' in one write (both must be taken), and
    # require a clean exit with the terminal restored. The render is 16x12
    # at 2 spp: a few seconds alone; the deadline allows for a loaded host.
    import pty

    mfd, sfd = pty.openpty()
    p = subprocess.Popen(
        [sys.executable, "-m", "qt_raytracer_tpu_torch.app.cli",
         "interactive", "--device", "cpu", "--scene", "three_sphere",
         "--width", "16", "--height", "12", "--spp", "2", "--depth", "3",
         "--ansi-cols", "24"],
        stdin=sfd, stdout=sfd, stderr=sfd, cwd=REPO, close_fds=True,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    os.close(sfd)
    out = b""
    deadline = time.time() + 120
    sent_quit = False
    try:
        while time.time() < deadline and p.poll() is None:
            r, _, _ = select.select([mfd], [], [], 0.2)
            if r:
                try:
                    out += os.read(mfd, 65536)
                except OSError:
                    break
            if not sent_quit and b"\x1b[" in out and b"Msamples" in out:
                os.write(mfd, b"wq")         # dolly (resets), then quit
                sent_quit = True
        rc = p.wait(timeout=5)
        while select.select([mfd], [], [], 0.2)[0]:
            try:
                chunk = os.read(mfd, 65536)
            except OSError:
                break
            if not chunk:
                break
            out += chunk
    finally:
        os.close(mfd)
        if p.poll() is None:
            p.kill()
            p.wait()
    assert sent_quit, out[-500:]
    assert rc == 0, (rc, out[-500:])
    assert b"\x1b[?25h" in out      # cursor restored on exit
