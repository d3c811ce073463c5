"""Thin-lens camera (counterpart of ``qt_raytracer_tpu.core.camera``).

Mirrors the reference camera model (include/raytracer/RayTracer.h:543-576)
with the JAX package's association order, so both packages round alike.
"""

from __future__ import annotations

import dataclasses

import torch

from . import sampling, vecmath as vm
from .scene import tensors_to
from ..runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    origin: torch.Tensor             # [3]
    lower_left_corner: torch.Tensor  # [3]
    horizontal: torch.Tensor         # [3]
    vertical: torch.Tensor           # [3]
    u: torch.Tensor                  # [3] camera-right
    v: torch.Tensor                  # [3] camera-up
    w: torch.Tensor                  # [3] backward (lookfrom - lookat, unit)
    lens_radius: torch.Tensor        # [] aperture / 2

    @property
    def device(self) -> torch.device:
        return self.origin.device

    def to(self, device) -> "Camera":
        return tensors_to(self, device)


def make_camera(
    lookfrom,
    lookat,
    vup=(0.0, 1.0, 0.0),
    vfov: float = 20.0,
    aspect_ratio: float = 16.0 / 9.0,
    aperture: float = 0.0,
    focus_dist: float = 1.0,
    dtype=torch.float32,
    device=None,
) -> Camera:
    """Build a Camera exactly as RayTracer.h:545-561 does: the arithmetic
    runs on the CPU (so the fields are the same bits wherever they end up),
    and the result moves to ``device`` (None: the CUDA card, which must be
    there)."""
    dev = resolve_device(device)
    f = lambda x: torch.as_tensor(x, dtype=dtype)
    lookfrom, lookat, vup = f(lookfrom), f(lookat), f(vup)
    vfov, aspect_ratio = f(vfov), f(aspect_ratio)
    focus_dist, aperture = f(focus_dist), f(aperture)

    theta = vm.degrees_to_radians(vfov)
    h = torch.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    w = vm.unit_vector(lookfrom - lookat)
    u = vm.unit_vector(vm.cross(vup, w))
    v = vm.cross(w, u)

    origin = lookfrom
    horizontal = focus_dist * viewport_width * u
    vertical = focus_dist * viewport_height * v
    lower_left_corner = origin - horizontal / 2.0 - vertical / 2.0 - focus_dist * w

    return Camera(origin=origin, lower_left_corner=lower_left_corner,
                  horizontal=horizontal, vertical=vertical, u=u, v=v, w=w,
                  lens_radius=aperture / 2.0).to(dev)


def get_rays(camera: Camera, s: torch.Tensor, t: torch.Tensor,
             lens_u1: torch.Tensor, lens_u2: torch.Tensor):
    """Batched Camera::get_ray (RayTracer.h:563-567).

    s, t: [N] viewport coordinates; lens_u1/u2: [N] lens-disk uniforms.
    Returns (origins [N,3], directions [N,3]); directions are not normalized.
    """
    rd = camera.lens_radius * sampling.random_in_unit_disk(lens_u1, lens_u2)
    offset = rd[..., 0:1] * camera.u + rd[..., 1:2] * camera.v
    origin = camera.origin + offset
    direction = (
        camera.lower_left_corner
        + s[..., None] * camera.horizontal
        + t[..., None] * camera.vertical
        - camera.origin
        - offset
    )
    return origin, direction
