"""Packed sphere parameter table (``packed_param_table`` of
``qt_raytracer_tpu.core.intersect``; the rest of that module is ported with
the gradient integrator, ROADMAP Queue A item 7)."""

from __future__ import annotations

import torch

from .scene import SphereScene


def packed_param_table(scene: SphereScene) -> torch.Tensor:
    """[S,16] f32 row table: cx cy cz r | ax ay az fuzz | ior mat ex ey | ez pad."""
    s = scene.num_spheres
    return torch.cat([
        scene.center,                                   # 0,1,2
        scene.radius[:, None],                          # 3
        scene.albedo,                                   # 4,5,6
        scene.fuzz[:, None],                            # 7
        scene.ior[:, None],                             # 8
        scene.mat_type[:, None].to(torch.float32),      # 9
        scene.emission,                                 # 10,11,12
        torch.zeros((s, 3), dtype=torch.float32, device=scene.device),
    ], dim=1)
