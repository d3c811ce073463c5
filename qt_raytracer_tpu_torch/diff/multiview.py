"""Multi-view inverse rendering: BASELINE config 5 (counterpart of
``qt_raytracer_tpu.diff.multiview``).

Joint recovery of scene fields (albedo, emitter radiance) and per-view
camera poses from M views of one scene. Per-view poses use the gauge-free
rigid-translation parameterization of ``inverse.make_train_step``: an [M, 3]
translate table applied to origin and lower_left_corner together.

Two execution shapes with one estimator and one update:
``make_multiview_train_step`` builds one graph over the M views and takes
one backward pass of their mean loss; ``make_multiview_train_step_perview``
takes one backward pass per view and averages the gradients. Memory stays
at one chunk's graph in both: inside ``render_linear`` every (chunk, sample
batch) is checkpointed, so a view's graph keeps only each chunk's inputs
(the JAX package's per-view ``jax.checkpoint`` would add a third forward
pass here and save nothing).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core import sampling
from ..core.config import RenderConfig
from ..core.render import render_sample_batch
from .inverse import (DEFAULT_TRAINABLE, TrainState, apply_update,
                      new_state, split_scene, step_setup, translate_camera,
                      value_and_grad)


def render_targets(scene, cameras: Sequence, cfg: RenderConfig, seed: int,
                   spp_per_call: int = 8) -> torch.Tensor:
    """Ground-truth mean-radiance targets [M, H, W, 3], rendered
    progressively in batches of spp_per_call samples with the key of seed
    + 1000 * v for view v (equal to mean_image at the same spp and key, up
    to the order of the sum)."""
    targets = []
    with torch.no_grad():
        for v, cam in enumerate(cameras):
            key = seed + 1000 * v
            acc = torch.zeros((cfg.height, cfg.width, 3),
                              dtype=torch.float32, device=cam.device)
            done = 0
            while done < cfg.spp:
                n = min(spp_per_call, cfg.spp - done)
                acc = acc + render_sample_batch(scene, cam, cfg, key, done, n)
                done += n
            targets.append(acc / cfg.spp)
    return torch.stack(targets)


def _setup(scene, cameras, cfg, trainable, train_camera, mesh, edge_aware,
           loss):
    cfg, loss_impl = step_setup(cfg, mesh, edge_aware, loss)
    cameras = tuple(cameras)
    m = len(cameras)
    scene_params, rebuild_scene = split_scene(scene, trainable)
    params = {"scene": scene_params}
    if train_camera == "pose":
        params["camera"] = {"translate": torch.zeros(
            (m, 3), dtype=torch.float32, device=cameras[0].device)}
    elif train_camera:
        raise ValueError("multiview supports train_camera='pose' or False")

    def rebuild_cameras(p):
        cp = p.get("camera")
        if cp is None:
            return cameras
        return tuple(translate_camera(cam, cp["translate"][v])
                     for v, cam in enumerate(cameras))

    def view_loss(p, v, target_v, key):
        """The loss of view v, with the view key fold_in(key, v)."""
        cam = rebuild_cameras(p)[v]
        words = sampling.key_words(key, target_v.device)
        return loss_impl(rebuild_scene(p["scene"]), cam, cfg,
                         sampling.fold_in(words, v), target_v, mesh)

    return m, params, rebuild_scene, rebuild_cameras, view_loss


def make_multiview_train_step(scene, cameras: Sequence, cfg: RenderConfig,
                              optimizer, trainable=DEFAULT_TRAINABLE,
                              train_camera="pose", mesh=None,
                              edge_aware: bool = False, loss: str = "l2"):
    """Build (init_state, step_fn, rebuild_scene, rebuild_cameras) for joint
    multi-view recovery of scene fields and per-view camera poses.

    step_fn(state, targets [M,H,W,3], key) -> (state, loss): one step on
    {"scene": {...}, "camera": {"translate": [M,3]}} with the mean of the
    M view losses (view v rendered with key fold_in(key, v)). Scene
    gradients sum over views; pose gradients are per view. optimizer: a
    factory params -> torch.optim.Optimizer (``inverse.adam``). mesh: a
    ``parallel.sharding.Mesh`` over whose ranks every view's render is
    sharded, as in ``inverse.make_train_step``."""
    m, params, rebuild_scene, rebuild_cameras, view_loss = _setup(
        scene, cameras, cfg, trainable, train_camera, mesh, edge_aware, loss)

    def loss_fn(p, targets, key):
        total = view_loss(p, 0, targets[0], key)
        for v in range(1, m):
            total = total + view_loss(p, v, targets[v], key)
        return total / m

    def init_state() -> TrainState:
        return new_state(params, optimizer)

    def step_fn(state: TrainState, targets, key):
        value, grads = value_and_grad(loss_fn, state.params, targets, key)
        return apply_update(state, grads), value

    return init_state, step_fn, rebuild_scene, rebuild_cameras


def make_multiview_train_step_perview(scene, cameras: Sequence,
                                      cfg: RenderConfig, optimizer,
                                      trainable=DEFAULT_TRAINABLE,
                                      train_camera="pose", mesh=None,
                                      edge_aware: bool = False,
                                      loss: str = "l2"):
    """The per-view variant of make_multiview_train_step: one forward and
    backward pass per view, gradients accumulated between them, then one
    update. The scanned loss is (1/M) sum_v loss_v, so its gradient is the
    mean of the per-view gradients taken here: the two steps agree up to
    the order of float sums. Same return values and step_fn signature."""
    m, params, rebuild_scene, rebuild_cameras, view_loss = _setup(
        scene, cameras, cfg, trainable, train_camera, mesh, edge_aware, loss)

    def init_state() -> TrainState:
        return new_state(params, optimizer)

    def step_fn(state: TrainState, targets, key):
        grads, total = None, 0.0
        for v in range(m):
            loss_v, g = value_and_grad(view_loss, state.params, v,
                                       targets[v], key)
            grads = g if grads is None else {k: grads[k] + g[k] for k in g}
            total = total + loss_v
        grads = {k: g / m for k, g in grads.items()}
        return apply_update(state, grads), total / m

    return init_state, step_fn, rebuild_scene, rebuild_cameras


def orbit_cameras(base_camera, offsets) -> tuple:
    """M camera rig: the base camera rigidly translated by each offset [3]."""
    return tuple(translate_camera(base_camera, torch.as_tensor(
        o, dtype=torch.float32, device=base_camera.device)) for o in offsets)
