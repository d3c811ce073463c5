"""Thin live-preview harness for progressive renders (counterpart of
``qt_raytracer_tpu.app.preview``).

Replaces the reference's Qt scene-graph display path (tile upload queue,
letterboxed viewport, progressive repaint — RayTracerFboItem.cpp:429-762)
with a UI-toolkit-free equivalent: a progressive render loop that
periodically emits the current accumulation as (a) a PNG file (for any
viewer to watch) and/or (b) an ANSI half-block image straight into the
terminal. Letterboxing matches chooseLetterboxRect semantics
(RayTracerFboItem.cpp:743-759).
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.config import RenderConfig
from .png import write_png
from .progressive import ProgressiveRenderer
from .stats import RenderStats, Timer, synchronize


def letterbox(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Aspect-preserving fit of img into (out_h, out_w), black bars around
    (RayTracerFboItem.cpp:743-759 arithmetic, nearest-neighbor resample)."""
    h, w = img.shape[:2]
    scale = min(out_w / w, out_h / h)
    tw, th = max(1, int(w * scale)), max(1, int(h * scale))
    ys = (np.arange(th) * h / th).astype(int)
    xs = (np.arange(tw) * w / tw).astype(int)
    fitted = img[ys][:, xs]
    out = np.zeros((out_h, out_w, 3), img.dtype)
    y0 = (out_h - th) // 2
    x0 = (out_w - tw) // 2
    out[y0:y0 + th, x0:x0 + tw] = fitted
    return out


def ansi_frame(img: np.ndarray, cols: int = 80) -> str:
    """Render a uint8 image as ANSI truecolor half-blocks (2 rows/char)."""
    h, w = img.shape[:2]
    rows = max(2, int(cols * h / w * 0.5) * 2)
    small = letterbox(img, cols, rows)
    lines = []
    for y in range(0, rows - 1, 2):
        line = []
        for x in range(cols):
            tr, tg, tb = (int(v) for v in small[y, x])
            br, bg, bb = (int(v) for v in small[y + 1, x])
            line.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(line) + "\x1b[0m")
    return "\n".join(lines)


def run_preview(scene, camera, cfg: RenderConfig, seed: int = 0,
                batch: int = 1, out_path: str | None = "preview.png",
                ansi: bool = False, ansi_cols: int = 80,
                stream=sys.stderr) -> ProgressiveRenderer:
    """Progressive render to completion with live output each step.

    Returns the finished ProgressiveRenderer (accum is resumable state).
    """
    pr = ProgressiveRenderer(scene, camera, cfg, seed=seed)
    timer = Timer()
    frames = 0
    while pr.frame_index < cfg.spp:
        pr.step(min(batch, cfg.spp - pr.frame_index))
        frames += 1
        img = pr.image()
        if out_path:
            write_png(out_path, img)
        if ansi:
            stream.write("\x1b[H\x1b[2J" + ansi_frame(img, ansi_cols) + "\n")
        synchronize(pr.device)
        stats = RenderStats(cfg.width, cfg.height, pr.frame_index,
                            cfg.max_depth, timer.elapsed_s, frames=frames,
                            backend=pr.device.type)
        stream.write(f"\r{stats.text()} | progress {pr.progress:5.1f}%\n"
                     if ansi else
                     f"progress {pr.progress:5.1f}% | {stats.text()}\n")
        stream.flush()
    return pr
