"""SoA sphere scene (counterpart of ``qt_raytracer_tpu.core.scene``).

Spheres are parallel tensors and materials are per-sphere parameters chosen
by an integer tag. A scene lives on one device; the render runs there.

Material tags:
    0 = Lambertian  (albedo)                RayTracer.h:473-488
    1 = Metal       (albedo, fuzz<=1)       RayTracer.h:490-504
    2 = Dielectric  (ior; white attenuation) RayTracer.h:506-540
    3 = Emissive    (emission)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
EMISSIVE = 3


@dataclasses.dataclass(frozen=True)
class SphereScene:
    """Structure-of-arrays sphere scene. S = number of sphere slots,
    including inactive padding slots."""

    center: torch.Tensor    # [S, 3] f32
    radius: torch.Tensor    # [S]    f32
    mat_type: torch.Tensor  # [S]    i32 material tag
    albedo: torch.Tensor    # [S, 3] f32 (lambertian/metal)
    fuzz: torch.Tensor      # [S]    f32 (metal; pre-clamped <= 1)
    ior: torch.Tensor       # [S]    f32 (dielectric)
    emission: torch.Tensor  # [S, 3] f32 (emissive radiance)
    active: torch.Tensor    # [S]    bool (False for padding slots)
    light_idx: torch.Tensor  # [L]   i32 indices of emissive spheres

    @property
    def num_spheres(self) -> int:
        return self.center.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.center.device

    def to(self, device) -> "SphereScene":
        return tensors_to(self, device)


def tensors_to(obj, device):
    """Copy of a frozen dataclass of tensors with every field on `device`."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)})


def _morton_order(centers: np.ndarray) -> np.ndarray:
    """Sort order along a 3D Morton (Z-order) curve, 10 bits per axis."""
    lo = centers.min(0)
    span = np.maximum(centers.max(0) - lo, 1e-12)
    q = np.clip(((centers - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


class SceneBuilder:
    """Host-side accumulation of primitives, then freeze to a SphereScene."""

    def __init__(self):
        self._rows = []  # (center, radius, mat_type, albedo, fuzz, ior, emission)

    def add_sphere(self, center, radius, mat_type=LAMBERTIAN,
                   albedo=(0.0, 0.0, 0.0), fuzz=0.0, ior=1.0,
                   emission=(0.0, 0.0, 0.0)) -> "SceneBuilder":
        # Metal constructor clamps fuzz to <= 1 (RayTracer.h:492).
        fuzz = min(float(fuzz), 1.0)
        self._rows.append((tuple(center), float(radius), int(mat_type),
                           tuple(albedo), float(fuzz), float(ior), tuple(emission)))
        return self

    def lambertian(self, center, radius, albedo):
        return self.add_sphere(center, radius, LAMBERTIAN, albedo=albedo)

    def metal(self, center, radius, albedo, fuzz=0.0):
        return self.add_sphere(center, radius, METAL, albedo=albedo, fuzz=fuzz)

    def dielectric(self, center, radius, ior=1.5):
        return self.add_sphere(center, radius, DIELECTRIC, ior=ior)

    def emissive(self, center, radius, emission):
        return self.add_sphere(center, radius, EMISSIVE, emission=emission)

    def build(self, pad_to: int | None = 128, dtype=torch.float32,
              spatial_sort: bool | None = None) -> SphereScene:
        """Freeze to SoA on the CPU (move it with ``.to(device)``).

        pad_to: round S up to a multiple; padded slots are inactive, parked
        at 1e9 and never hit. spatial_sort: Morton-order the spheres; default
        on for scenes with >= 64 spheres, as in the JAX package.
        """
        n = len(self._rows)
        if n == 0:
            raise ValueError("scene has no primitives")
        if spatial_sort is None:
            spatial_sort = n >= 64
        if spatial_sort and n > 1:
            centers = np.array([r[0] for r in self._rows], np.float64)
            order = _morton_order(centers)
            self._rows = [self._rows[i] for i in order]
        total = n
        if pad_to:
            total = ((n + pad_to - 1) // pad_to) * pad_to
        center = np.zeros((total, 3), np.float64)
        radius = np.zeros((total,), np.float64)
        mat_type = np.zeros((total,), np.int32)
        albedo = np.zeros((total, 3), np.float64)
        fuzz = np.zeros((total,), np.float64)
        ior = np.ones((total,), np.float64)
        emission = np.zeros((total, 3), np.float64)
        active = np.zeros((total,), bool)
        for i, (c, r, mt, alb, fz, io, em) in enumerate(self._rows):
            center[i] = c
            radius[i] = r
            mat_type[i] = mt
            albedo[i] = alb
            fuzz[i] = fz
            ior[i] = io
            emission[i] = em
            active[i] = True
        center[n:] = 1.0e9
        lights = np.nonzero(mat_type == EMISSIVE)[0].astype(np.int32)
        f = lambda x: torch.from_numpy(x).to(dtype)
        return SphereScene(
            center=f(center), radius=f(radius),
            mat_type=torch.from_numpy(mat_type), albedo=f(albedo),
            fuzz=f(fuzz), ior=f(ior), emission=f(emission),
            active=torch.from_numpy(active), light_idx=torch.from_numpy(lights),
        )
