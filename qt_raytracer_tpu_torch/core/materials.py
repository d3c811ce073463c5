"""Materials as masked vector evaluation on [N, 3] tensors (counterpart of
``qt_raytracer_tpu.core.materials``, used by the gradient integrator
``core.integrator.trace``).

All three BSDFs are evaluated for every ray and the result is selected by
material tag. Every branch reads fixed uniform slots (core/sampling.py
layout), so the random stream does not depend on which branch wins.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import sampling, vecmath as vm
from .scene import DIELECTRIC, EMISSIVE, LAMBERTIAN, METAL


class Scatter(NamedTuple):
    direction: torch.Tensor    # [N,3] next ray direction
    attenuation: torch.Tensor  # [N,3] throughput multiplier
    ok: torch.Tensor           # [N] bool: ray continues (False = absorbed)
    emitted: torch.Tensor      # [N,3] radiance emitted at the hit


def scatter(mat_type, albedo, fuzz, ior, emission, in_dir, normal,
            front_face, uniforms) -> Scatter:
    """Batched scatter for all rays on the winners' material parameters
    (Hits.mat_type .. emission). uniforms: the [N, 8] per-bounce block."""
    u0, u1, u2, u3 = (uniforms[:, i] for i in range(4))
    unit_in = vm.safe_unit_vector(in_dir)

    # Lambertian (RayTracer.h:473-488): normal + random_unit_vector, with
    # the degenerate-direction guard.
    lam_dir = normal + sampling.random_unit_vector(u0, u1)
    degenerate = vm.length_squared(lam_dir) < 1.0e-8
    lam_dir = torch.where(degenerate[:, None], normal, lam_dir)

    # Metal (RayTracer.h:490-504): mirror + fuzz * in_unit_sphere; absorbed
    # when scattered below the surface.
    reflected = vm.reflect(unit_in, normal)
    met_dir = reflected + fuzz[:, None] * sampling.random_in_unit_sphere(
        u0, u1, u2)
    met_ok = vm.dot(met_dir, normal) > 0.0

    # Dielectric (RayTracer.h:506-540): Schlick vs uniform, TIR check, white
    # attenuation.
    ratio = torch.where(front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp_max(vm.dot(-unit_in, normal), 1.0)
    sin_theta = vm.safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = ratio * sin_theta > 1.0
    must_reflect = cannot_refract | (_reflectance(cos_theta, ratio) > u3)
    die_dir = torch.where(must_reflect[:, None], reflected,
                          vm.refract(unit_in, normal, ratio))

    is_lam = mat_type == LAMBERTIAN
    is_met = mat_type == METAL
    is_die = mat_type == DIELECTRIC
    is_emit = mat_type == EMISSIVE
    direction = torch.where(is_lam[:, None], lam_dir,
                            torch.where(is_met[:, None], met_dir, die_dir))
    attenuation = torch.where((is_die | is_emit)[:, None], 1.0, albedo)
    ok = torch.where(is_met, met_ok, ~is_emit)
    emitted = torch.where(is_emit[:, None], emission, 0.0)
    return Scatter(direction, attenuation, ok, emitted)


def _reflectance(cosine, ref_idx):
    """Schlick's approximation (RayTracer.h:531-536)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    om = 1.0 - cosine
    om2 = om * om
    return r0 + (1.0 - r0) * (om * (om2 * om2))  # integer_pow(om, 5)
