"""World = spheres + optional triangle mesh (counterpart of
``qt_raytracer_tpu.core.world``, forward path).

Both primitive families share one id space: ids below num_spheres are
spheres, id num_spheres + j is triangle j of the (BVH-ordered) mesh. The
offset keeps next-event estimation's shadow test ("the first hit IS the
chosen light") right when meshes occlude. The world light table (emissive
spheres, then emissive faces) drives NEE/MIS.

``intersect_world`` and ``_tri_t_diff`` serve the [N,3] gradient integrator
and are ported with it (ROADMAP Queue A item 7).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..accel.mesh import TriangleMesh
from .scene import SphereScene


@dataclasses.dataclass(frozen=True)
class World:
    spheres: SphereScene
    mesh: Optional[TriangleMesh]

    @property
    def device(self) -> torch.device:
        return self.spheres.device

    def to(self, device) -> "World":
        return World(self.spheres.to(device),
                     None if self.mesh is None else self.mesh.to(device))


def as_world(scene) -> World:
    """Accept a bare SphereScene or a full World."""
    if isinstance(scene, World):
        return scene
    return World(spheres=scene, mesh=None)


class WorldLights(NamedTuple):
    """Light table over both primitive families.

    table [L,16] rows (the first n_sphere rows are spheres):
      sphere:   cx cy cz r  | 0 0 0 0 0 | ex ey ez | 0 0 0 0
      triangle: v0(3) e1(3) e2(3)       | ex ey ez | 0 0 0 0
    expected_prim [L]: the unified prim id the NEE shadow ray must hit first
    for the sample to count.
    """
    table: torch.Tensor          # [L, 16] f32
    expected_prim: torch.Tensor  # [L] i32
    n_sphere: int
    n_total: int


def world_lights(world: World) -> WorldLights:
    """Assemble the light table on the world's device."""
    sc = world.spheres
    mesh = world.mesh
    ls = sc.num_lights
    lt = mesh.num_lights if mesh is not None else 0
    dev = world.device
    rows = []
    prim = []
    if ls:
        li = sc.light_idx.long()
        z = torch.zeros((ls, 1), dtype=torch.float32, device=dev)
        rows.append(torch.cat(
            [sc.center[li], sc.radius[li][:, None], z, z, z, z, z,
             sc.emission[li], z, z, z, z], dim=1))
        prim.append(sc.light_idx)
    if lt:
        ti = mesh.light_tri.long()
        z = torch.zeros((lt, 1), dtype=torch.float32, device=dev)
        rows.append(torch.cat(
            [mesh.v0[ti], mesh.e1[ti], mesh.e2[ti], mesh.emission[ti],
             z, z, z, z], dim=1))
        prim.append(sc.num_spheres + mesh.light_tri)
    if not rows:
        return WorldLights(torch.zeros((0, 16), dtype=torch.float32, device=dev),
                           torch.zeros((0,), dtype=torch.int32, device=dev),
                           0, 0)
    return WorldLights(torch.cat(rows, dim=0),
                       torch.cat(prim, dim=0).to(torch.int32), ls, ls + lt)


def face_param_table(mesh: TriangleMesh) -> torch.Tensor:
    """[F,16] per-face row: gnx gny gnz area | ax ay az fuzz | ior mat ex ey |
    ez pad -- the sphere packed_param_table's slots 4..12, with the unit
    geometric normal and the face area in slots 0-3."""
    f = mesh.num_triangles
    e1, e2 = mesh.e1, mesh.e2
    cr = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                      e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                      e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
    area = 0.5 * torch.linalg.vector_norm(cr, dim=1)
    return torch.cat([
        mesh.geom_normal,                              # 0,1,2
        area[:, None],                                 # 3
        mesh.albedo,                                   # 4,5,6
        mesh.fuzz[:, None],                            # 7
        mesh.ior[:, None],                             # 8
        mesh.mat_type[:, None].to(torch.float32),      # 9
        mesh.emission,                                 # 10,11,12
        torch.zeros((f, 3), dtype=torch.float32, device=mesh.device),
    ], dim=1)
