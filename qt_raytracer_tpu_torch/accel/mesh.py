"""Triangle meshes: SoA geometry with per-face materials (counterpart of
``qt_raytracer_tpu.accel.mesh``).

Triangles are expanded to per-triangle SoA (v0, e1, e2, unit geometric
normal), reordered into BVH leaf order, and carry one material row per face
(the sphere parameter model: tag, albedo, fuzz, ior, emission). The build
runs on the host in numpy float64 and freezes to float32 tensors, exactly as
the JAX package freezes to jnp arrays, so one input gives the same tensors bit
for bit; they land on the CUDA card unless the caller names another device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.scene import EMISSIVE, tensors_to
from ..runtime.device import resolve_device

# The builder the last build_mesh call ran: "native" (C++ SAH) or "numpy"
# (median split). "auto" takes native when the library builds and loads; the
# two give different triangle orders.
last_builder: str | None = None


@dataclasses.dataclass(frozen=True)
class TriangleMesh:
    """SoA triangle soup in BVH leaf order, with per-face materials."""

    v0: torch.Tensor           # [F, 3] f32 first vertex
    e1: torch.Tensor           # [F, 3] f32 v1 - v0
    e2: torch.Tensor           # [F, 3] f32 v2 - v0
    geom_normal: torch.Tensor  # [F, 3] f32 unit geometric normal
    # Flattened BVH (accel/bvh.py layout), escape-index DFS:
    bvh_min: torch.Tensor      # [M, 3] f32
    bvh_max: torch.Tensor      # [M, 3] f32
    bvh_escape: torch.Tensor   # [M] i32
    bvh_start: torch.Tensor    # [M] i32
    bvh_count: torch.Tensor    # [M] i32
    # Per-face materials:
    mat_type: torch.Tensor     # [F] i32
    albedo: torch.Tensor       # [F, 3] f32
    fuzz: torch.Tensor         # [F] f32
    ior: torch.Tensor          # [F] f32
    emission: torch.Tensor     # [F, 3] f32
    light_tri: torch.Tensor    # [Lt] i32 emissive face ids (BVH order)

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_tri.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def to(self, device) -> "TriangleMesh":
        return tensors_to(self, device)


def _per_face(x, f: int, width: int | None) -> np.ndarray:
    """Broadcast a scalar/single-row material field to [F] (or [F, width])."""
    a = np.asarray(x, np.float64)
    if width is None:
        return np.broadcast_to(a.reshape(-1), (f,)) if a.size == 1 \
            else a.reshape(f)
    if a.ndim == 1:
        a = a.reshape(1, width)
    return np.broadcast_to(a, (f, width))


def build_mesh(vertices: np.ndarray, faces: np.ndarray,
               mat_type=0, albedo=(0.8, 0.8, 0.8), fuzz=0.0,
               ior=1.5, emission=(0.0, 0.0, 0.0),
               max_leaf: int = 4, builder: str = "auto",
               device=None) -> TriangleMesh:
    """Host-side mesh freeze: expand triangles, build the BVH, reorder, and
    put the tensors on ``device`` (None: the CUDA card, which must be there).

    Material fields are scalars/single RGB rows (every face) or per-face
    arrays ([F] / [F,3]). builder: "native" (C++ SAH, raises if the library
    is unavailable), "numpy" (median split) or "auto" (native, else numpy).
    """
    global last_builder
    dev = resolve_device(device)
    if builder not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown BVH builder {builder!r}")
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    f = len(faces)
    tri = vertices[faces]                      # [F, 3, 3]
    bb_min = tri.min(axis=1).astype(np.float32)
    bb_max = tri.max(axis=1).astype(np.float32)
    # Epsilon-pad the primitive boxes: axis-aligned faces have zero-thickness
    # boxes that the strict slab test (exit > enter) never passes.
    scale = float(max(bb_max.max() - bb_min.min(), 1e-3))
    eps = np.float32(1e-5 * scale)
    bb_min -= eps
    bb_max += eps

    bvh, used = None, "numpy"
    if builder in ("auto", "native"):
        from ..runtime.native_bvh import build_bvh_native
        try:
            bvh, used = build_bvh_native(bb_min, bb_max, max_leaf=max_leaf), \
                "native"
        except RuntimeError:
            if builder == "native":
                raise
    if bvh is None:
        from .bvh import build_bvh
        bvh = build_bvh(bb_min, bb_max, max_leaf=max_leaf)
    last_builder = used

    order = bvh.prim_order
    tri = tri[order]                           # leaf-contiguous order
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)

    mt = _per_face(mat_type, f, None).astype(np.int32)[order]
    alb = _per_face(albedo, f, 3)[order]
    fz = np.minimum(_per_face(fuzz, f, None), 1.0)[order]  # Metal fuzz <= 1
    io = _per_face(ior, f, None)[order]
    em = _per_face(emission, f, 3)[order]
    lights = np.nonzero(mt == EMISSIVE)[0].astype(np.int32)

    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    i32 = lambda x: torch.from_numpy(
        np.ascontiguousarray(x, np.int32)).to(dev)
    return TriangleMesh(
        v0=f32(v0), e1=f32(e1), e2=f32(e2), geom_normal=f32(n),
        bvh_min=f32(bvh.bbox_min), bvh_max=f32(bvh.bbox_max),
        bvh_escape=i32(bvh.escape), bvh_start=i32(bvh.prim_start),
        bvh_count=i32(bvh.prim_count),
        mat_type=i32(mt), albedo=f32(alb), fuzz=f32(fz), ior=f32(io),
        emission=f32(em), light_tri=i32(lights),
    )


class TriHit(NamedTuple):
    t: torch.Tensor        # [N] f32 (BIG on a miss)
    tri_idx: torch.Tensor  # [N] i32
    hit: torch.Tensor      # [N] bool


def moller_trumbore(v0, e1, e2, o, d, t_min, t_max):
    """Batched Moller-Trumbore: triangles [K,3] against rays [N,3] -> t
    [N,K], with backface culling off (both orientations hit) and BIG where
    there is no valid hit."""
    big = float(np.float32(3.0e38))
    p = vm.cross(d[:, None, :], e2[None, :, :])           # [N,K,3]
    det = _dot3(p, e1[None, :, :])                        # [N,K]
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    s = o[:, None, :] - v0[None, :, :]                    # [N,K,3]
    u = _dot3(s, p) * inv_det
    q = vm.cross(s, e1[None, :, :])                       # [N,K,3]
    v = _dot3(q, d[:, None, :]) * inv_det
    t = _dot3(q, e2[None, :, :]) * inv_det
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= t_min) & (t <= t_max))
    return torch.where(ok, t, big)


def _dot3(a, b):
    """a . b over the last axis, summed left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


class MeshBuilder:
    """Host-side accumulation of multi-material triangle geometry, frozen to
    ONE TriangleMesh (one BVH, per-face material rows)."""

    def __init__(self):
        self._verts: list[np.ndarray] = []
        self._faces: list[np.ndarray] = []
        self._mats: list[tuple] = []   # (count, mat_type, albedo, fuzz, ior, emission)
        self._nv = 0

    def add_triangles(self, vertices, faces, mat_type=0,
                      albedo=(0.8, 0.8, 0.8), fuzz=0.0, ior=1.5,
                      emission=(0.0, 0.0, 0.0)) -> "MeshBuilder":
        vertices = np.asarray(vertices, np.float64).reshape(-1, 3)
        faces = np.asarray(faces, np.int64).reshape(-1, 3)
        self._verts.append(vertices)
        self._faces.append(faces + self._nv)
        self._mats.append((len(faces), mat_type, albedo, fuzz, ior, emission))
        self._nv += len(vertices)
        return self

    def add_quad(self, corner, edge_u, edge_v, **mat) -> "MeshBuilder":
        """Parallelogram (corner, corner+u, corner+u+v, corner+v) as 2 tris;
        geometric normal = normalize(u x v)."""
        c = np.asarray(corner, np.float64)
        u = np.asarray(edge_u, np.float64)
        v = np.asarray(edge_v, np.float64)
        verts = np.stack([c, c + u, c + u + v, c + v])
        faces = np.array([[0, 1, 2], [0, 2, 3]])
        return self.add_triangles(verts, faces, **mat)

    def add_box(self, center, size, rotate_y: float = 0.0,
                **mat) -> "MeshBuilder":
        """Axis-aligned box (optionally rotated about +y), 12 tris, outward
        normals."""
        cx, cy, cz = np.asarray(center, np.float64)
        sx, sy, sz = np.asarray(size, np.float64) / 2.0
        corners = np.array([[x, y, z]
                            for x in (-sx, sx) for y in (-sy, sy)
                            for z in (-sz, sz)])
        if rotate_y:
            a = np.deg2rad(rotate_y)
            rot = np.array([[np.cos(a), 0, np.sin(a)],
                            [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]])
            corners = corners @ rot.T
        corners += np.array([cx, cy, cz])
        # index bits: x*4 + y*2 + z; quads with outward winding
        quads = [(0, 1, 3, 2), (4, 6, 7, 5),    # -x, +x
                 (0, 4, 5, 1), (2, 3, 7, 6),    # -y, +y
                 (0, 2, 6, 4), (1, 5, 7, 3)]    # -z, +z
        faces = []
        for q in quads:
            faces += [[q[0], q[1], q[2]], [q[0], q[2], q[3]]]
        return self.add_triangles(corners, np.array(faces), **mat)

    def build(self, max_leaf: int = 4, builder: str = "auto",
              device=None) -> TriangleMesh:
        if not self._faces:
            raise ValueError("mesh has no triangles")
        verts = np.concatenate(self._verts)
        faces = np.concatenate(self._faces)

        def expand(field: int, width):
            parts = []
            for cnt, *mats in self._mats:
                shape = (cnt,) if width is None else (cnt, width)
                row = np.asarray(mats[field], np.float64).reshape(
                    (1,) if width is None else (1, width))
                parts.append(np.broadcast_to(row, shape))
            return np.concatenate(parts)

        return build_mesh(
            verts, faces,
            mat_type=expand(0, None).astype(np.int32),
            albedo=expand(1, 3), fuzz=expand(2, None), ior=expand(3, None),
            emission=expand(4, 3), max_leaf=max_leaf, builder=builder,
            device=device)
