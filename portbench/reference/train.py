"""The plain reference of an inverse-rendering train step: the target, the
L2 image loss, its pathwise gradient and Adam with the physical clamps, in
plain PyTorch on the reference tracer, pixel block by pixel block.

The leaves are named as the port names them: "scene/albedo",
"scene/emission" ([S, 3], the input spheres in input order) and
"camera/translate" ([3]).

The reference of every configuration without a "reference" key: its frame
interface is the tracer's.
"""

from __future__ import annotations

import torch

from . import tracer
from .tracer import make_camera, make_scene, render_pixels  # noqa: F401

BETAS = (0.9, 0.999)
EPS = 1e-8


def _pixels(settings: dict) -> int:
    return int(settings["width"]) * int(settings["height"])


def render_image(sc, cam, settings: dict, key, dtype, block: int):
    """[H*W, 3] per-sample mean image, without gradient."""
    n = _pixels(settings)
    dev = sc.center.device
    out = torch.empty((n, 3), dtype=dtype, device=dev)
    with torch.no_grad():
        for lo in range(0, n, block):
            pix = torch.arange(lo, min(lo + block, n), device=dev)
            out[lo:lo + block] = tracer.render_pixels(
                sc, cam, settings, key, pix, dtype) / int(settings["spp"])
    return out


def loss_and_grads(sc, cam_params: dict, settings: dict, key, target,
                   leaves: dict, dtype, block: int):
    """(loss, {leaf: gradient}) of mean((image - target)^2) over every
    pixel and channel, accumulated block by block."""
    n = _pixels(settings)
    dev = sc.center.device
    aspect = int(settings["width"]) / int(settings["height"])
    for t in leaves.values():
        t.grad = None
    total = 0.0
    for lo in range(0, n, block):
        pix = torch.arange(lo, min(lo + block, n), device=dev)
        cam = tracer.make_camera(cam_params, aspect, dtype, dev,
                                 translate=leaves["camera/translate"])
        img = tracer.render_pixels(
            sc, cam, settings, key, pix, dtype,
            albedo=leaves["scene/albedo"],
            emission=leaves["scene/emission"]) / int(settings["spp"])
        part = ((img - target[lo:lo + block]) ** 2).sum() / (3 * n)
        part.backward()
        total += float(part.detach())
    return total, {k: (torch.zeros_like(t) if t.grad is None
                       else t.grad.detach().clone())
                   for k, t in leaves.items()}


class Adam:
    """torch.optim.Adam's update, written out: one learning rate a leaf."""

    def __init__(self, leaves: dict, lr: dict):
        self.lr = lr
        self.m = {k: torch.zeros_like(t) for k, t in leaves.items()}
        self.v = {k: torch.zeros_like(t) for k, t in leaves.items()}
        self.t = 0

    def step(self, leaves: dict, grads: dict) -> None:
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        with torch.no_grad():
            for k, p in leaves.items():
                g = grads[k]
                self.m[k] = b1 * self.m[k] + (1.0 - b1) * g
                self.v[k] = b2 * self.v[k] + (1.0 - b2) * g * g
                denom = torch.sqrt(self.v[k]) / c2 ** 0.5 + EPS
                p -= (self.lr[k] / c1) * self.m[k] / denom


def clamp(leaves: dict) -> None:
    with torch.no_grad():
        leaves["scene/albedo"].clamp_(0.0, 1.0)
        leaves["scene/emission"].clamp_min_(0.0)


def steps(true_inputs: dict, start_inputs: dict, cfg: dict, keys,
          tgt_key, dtype, device, block: int = 1 << 17, count: int = 3):
    """The first `count` steps from the starting point: each step's loss,
    the first step's gradient and the change of every leaf after the last.
    keys: [count, 2] step keys; tgt_key: the target's key."""
    settings = cfg["render"]
    aspect = int(settings["width"]) / int(settings["height"])
    cam_cfg = cfg["camera"]
    true_sc = tracer.make_scene(true_inputs, dtype, device)
    target = render_image(true_sc, tracer.make_camera(cam_cfg, aspect, dtype,
                                                      device),
                          settings, tgt_key.to(device), dtype, block)
    del true_sc
    sc = tracer.make_scene(start_inputs, dtype, device)
    pose = torch.as_tensor(cfg["train"]["pose_error"], dtype=torch.float64)
    start_cam = dict(cam_cfg)
    start_cam["lookfrom"] = (torch.as_tensor(cam_cfg["lookfrom"],
                                             dtype=torch.float64) + pose
                             ).tolist()
    start_cam["lookat"] = (torch.as_tensor(cam_cfg["lookat"],
                                           dtype=torch.float64) + pose
                           ).tolist()
    leaves = {"scene/albedo": sc.albedo.clone().requires_grad_(True),
              "scene/emission": sc.emission.clone().requires_grad_(True),
              "camera/translate": torch.zeros(3, dtype=dtype, device=device,
                                              requires_grad=True)}
    initial = {k: t.detach().clone() for k, t in leaves.items()}
    opt = Adam(leaves, dict(cfg["train"]["lr"]))
    losses, first = [], None
    for k in range(count):
        loss, grads = loss_and_grads(sc, start_cam, settings,
                                     keys[k].to(device), target, leaves,
                                     dtype, block)
        losses.append(loss)
        if first is None:
            first = grads
        opt.step(leaves, grads)
        clamp(leaves)
    change = {k: (t.detach() - initial[k]) for k, t in leaves.items()}
    return {"losses": losses, "grad": first, "change": change}

