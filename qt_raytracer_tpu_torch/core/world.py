"""World = spheres + optional triangle mesh (counterpart of
``qt_raytracer_tpu.core.world``).

Both primitive families share one id space: ids below num_spheres are
spheres, id num_spheres + j is triangle j of the (BVH-ordered) mesh. The
offset keeps next-event estimation's shadow test ("the first hit IS the
chosen light") right when meshes occlude. The world light table (emissive
spheres, then emissive faces) drives NEE/MIS.

``intersect_world`` is the merged closest hit of the [N,3] gradient
integrator: the sphere search (kernel A5, or A6 from 1,024 slots on), then
the mesh search (A3, with A4 and the crossing sort on multi-cluster meshes;
or, with ``mesh_kernel="pairs"``, the pair-wavefront search A7 and A8)
capped by the sphere winner, both detached; under ``backend="xla"`` the
[N, S] sphere search and the BVH walk (``accel.traverse``), uncapped. The
winning triangle's t is re-derived differentiably (``_tri_t_diff``) and its
face row supplies the rest.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..accel.mesh import TriangleMesh
from ..accel.traverse import intersect_mesh
from . import vecmath as vm
from ..kernels.mesh_intersect import CLUSTER_ROWS
from ..runtime.spans import HIT_MESH, spanned
from .config import MESH_KERNELS
from .intersect import BIG, Hits, intersect_spheres
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


def tensors_of(obj) -> list:
    """Every tensor field of a SphereScene, TriangleMesh, Camera or World."""
    if isinstance(obj, World):
        return tensors_of(obj.spheres) + (
            [] if obj.mesh is None else tensors_of(obj.mesh))
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


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


def _tri_t_diff(mesh: TriangleMesh, tri_idx, o, d, t_min, t_max):
    """Differentiable Moller-Trumbore t of per-lane selected triangles (the
    gradient path for mesh geometry; the search itself is detached)."""
    v0, e1, e2 = (vm.gather_rows(x, tri_idx)
                  for x in (mesh.v0, mesh.e1, mesh.e2))
    p = vm.cross(d, e2)
    det = torch.sum(p * e1, dim=-1)
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    q = vm.cross(o - v0, e1)
    t = torch.sum(q * e2, dim=-1) * inv_det
    return t, ok & (t >= t_min) & (t <= t_max)


@spanned(HIT_MESH)
def search_mesh(mc, ox, oy, oz, dx, dy, dz, t_min: float,
                alive, t_cap, *, mesh_kernel: str = "clustered",
                depth_idx=None, pair_c: int = 6, sort0: bool = True,
                exclude=None, interpret: bool = False, **clustered):
    """The mesh search an integrator asks for, by policy; every choice gives
    live lanes the same bits. mesh_kernel "pairs": the pair-wavefront search;
    "hybrid" with a bounce index: the clustered search at bounce 0, whose
    rays arrive in pixel order, and the pair search on bounce wavefronts;
    "clustered", or "hybrid" without a bounce index: the clustered search.
    An exclude operand always takes the clustered search (the pair kernels
    have none). sort0=False leaves the clustered search unsorted at bounce
    0, where the sort buys nothing. clustered: the clustered search's
    options (sort_mode, mt, visit), which mesh_search takes and the
    pair search hands to its fallback; mc carries the tables they read."""
    if mesh_kernel not in MESH_KERNELS:
        raise ValueError(f"mesh_kernel must be one of {MESH_KERNELS}, got "
                         f"{mesh_kernel!r}")
    from ..kernels.mesh_intersect import mesh_search
    from ..kernels.mesh_pairs import mesh_search_pairs

    rays = (ox, oy, oz, dx, dy, dz)
    bounce0 = depth_idx is not None and depth_idx == 0
    pairs = mesh_kernel == "pairs" or (
        mesh_kernel == "hybrid" and depth_idx is not None and not bounce0)
    if pairs and exclude is None:
        return mesh_search_pairs(mc, *rays, t_min, alive, t_cap,
                                 pair_c=pair_c, interpret=interpret,
                                 **clustered)
    sort = sort0 or not bounce0 or mesh_kernel == "hybrid"
    return mesh_search(mc, *rays, t_min, alive=alive, t_cap=t_cap, sort=sort,
                       exclude=exclude, interpret=interpret, **clustered)


def intersect_world(world: World, origins, directions, t_min,
                    backend: str = "pallas", alive=None,
                    exclude=None, mesh_kernel: str = "clustered",
                    mesh_pair_c: int = 6,
                    mesh_sort_mode: str = "crossing",
                    mesh_visit: str = "full", mesh_mt: str = "vpu",
                    mesh_cluster_rows: int = CLUSTER_ROWS) -> Hits:
    """Closest hit over every primitive family, merged into one Hits with
    one id space (triangle j is prim num_spheres + j), on a strict '<'.

    backend: "pallas" (the kernels on CUDA tensors, their plain versions on
    CPU tensors), "pallas_interpret" (the plain versions) or "xla" (the
    [N, S] sphere search and the BVH walk, whose kernel runs on CUDA
    tensors and its plain version on CPU tensors).

    exclude: optional [N] integer unified prim id to leave out of each
    lane's search (-1 for none): an id below num_spheres excludes that
    sphere, an id from num_spheres on excludes triangle id - num_spheres
    from the mesh search (the edge-aware background re-trace).

    mesh_kernel: "pairs" takes the pair-wavefront mesh search (list width
    mesh_pair_c) unless an exclude id is given, which the pair kernels do
    not take; "clustered" and "hybrid" take the clustered search, sorted by
    mesh_sort_mode. mesh_visit and mesh_mt pick the clustered search's
    body, mesh_cluster_rows its cluster size (RenderConfig's fields of
    those names). Live lanes get the same
    bits under every choice but mesh_mt="mxu". Under "xla" none of these
    options changes anything: the mesh search is the walk, as the JAX
    package switches mesh kernels only under Pallas."""
    ns = world.spheres.num_spheres
    excl_s = excl_m = None
    if exclude is not None:
        exclude = exclude.detach().to(torch.int32)
        excl_s = torch.where((exclude >= 0) & (exclude < ns), exclude, -1)
        excl_m = torch.where(exclude >= ns, exclude - ns, -1)
    hs = intersect_spheres(world.spheres, origins, directions, t_min,
                           backend=backend, alive=alive, exclude=excl_s)
    mesh = world.mesh
    if mesh is None:
        return hs
    if backend == "xla":
        th = intersect_mesh(mesh, origins, directions, t_min, alive=alive,
                            exclude=excl_m)
        t_m, idx_m = th.t, th.tri_idx
    else:
        from ..kernels.mesh_intersect import prep_mesh_clusters

        # The sphere winner caps the mesh search: clusters beyond it prune,
        # and lanes whose winner is a sphere come back as a mesh miss.
        with torch.no_grad():
            comps = [x[:, k].contiguous() for x in (origins, directions)
                     for k in range(3)]
            n = origins.shape[0]
            live = alive if alive is not None else \
                torch.ones(n, dtype=torch.bool, device=origins.device)
            mc = prep_mesh_clusters(mesh, cluster_rows=mesh_cluster_rows,
                                    mt=mesh_mt)
            t_m, idx_m = search_mesh(
                mc, *comps, float(t_min), live.contiguous(),
                torch.where(hs.hit, hs.t, BIG).contiguous(),
                mesh_kernel=mesh_kernel, pair_c=mesh_pair_c,
                sort_mode=mesh_sort_mode, visit=mesh_visit, mt=mesh_mt,
                exclude=excl_m,
                interpret=backend == "pallas_interpret")
    tri_hit = t_m < BIG
    t_d, ok_d = _tri_t_diff(mesh, idx_m, origins, directions, t_min, BIG)
    t_tri = torch.where(tri_hit & ok_d, t_d, t_m)

    closer = tri_hit & (~hs.hit | (t_tri < hs.t))
    t = torch.where(closer, t_tri, hs.t)
    hit = hs.hit | tri_hit
    prim_idx = torch.where(closer, world.spheres.num_spheres + idx_m,
                           hs.prim_idx)
    t_safe = torch.where(hit, t, 1.0)
    point_m = origins + t_safe[:, None] * directions
    fp = vm.gather_rows(face_param_table(mesh), idx_m)        # [N,16]
    gn = fp[:, 0:3]
    ff_m = vm.dot(directions, gn) < 0.0
    normal_m = torch.where(ff_m[:, None], gn, -gn)

    sel3 = lambda m_val, s_val: torch.where(closer[:, None], m_val, s_val)
    sel1 = lambda m_val, s_val: torch.where(closer, m_val, s_val)
    return Hits(
        t=t, prim_idx=prim_idx, hit=hit,
        point=sel3(point_m, hs.point),
        normal=sel3(normal_m, hs.normal),
        front_face=sel1(ff_m, hs.front_face),
        mat_type=sel1(fp[:, 9].to(torch.int32), hs.mat_type),
        albedo=sel3(fp[:, 4:7], hs.albedo),
        fuzz=sel1(fp[:, 7], hs.fuzz),
        ior=sel1(fp[:, 8], hs.ior),
        emission=sel3(fp[:, 10:13], hs.emission),
        radius=sel1(torch.zeros_like(t), hs.radius),
        area=sel1(fp[:, 3], torch.zeros_like(t)),
    )
