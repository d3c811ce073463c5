"""Sphere closest-hit search of the gradient integrator: the CUDA kernel's
wrapper and its plain version (counterpart of
``qt_raytracer_tpu.kernels.sphere_intersect``, kernel A5).

Per ray, the closest valid root over every sphere slot: ``t`` is the
unrefined sweep minimum (BIG on a miss) and ``idx`` the lowest winning id (0
on a miss). The table is the TPU kernel's: inactive slots biased by +BIG,
padded to a multiple of 64 slots parked at 1e9. Both outputs are detached:
``core.intersect.intersect_spheres`` re-derives every differentiable
quantity from ``idx``.

``sphere_search`` launches ``qtrt_sphere_search`` (``csrc/fused_hit.cu``,
the A2 sweep behind its own entry) for CUDA tensors, and takes
``sphere_search_plain`` only for CPU tensors or with ``interpret=True``; on
a CUDA tensor it launches the kernel or raises. Dead lanes read (BIG, 0):
the kernel gates each lane, where the TPU kernel skips whole dead 128-ray
rows and searches the dead lanes of live rows.

Not ported: the per-lane exclude operand (ROADMAP Queue A item 8) and the
cluster-culled sweep the TPU kernel takes from 1,024 slots on (kernel A6,
item 12); both raise NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm
from ..core.scene import SphereScene
from ..runtime import cuda_build
from .fused_hit import BIG, PLAIN_SLICE, _sweep

CHUNK_S = 64                 # the table is padded to a multiple of this
MIN_CHUNKS_FOR_CULLING = 16  # from 16 chunks (1,024 slots) the TPU takes A6

# Launches of the A5 kernel; a run resets it to 0 and reads it back to show
# that its path went through the kernel.
launches = 0


class SearchSpheres(NamedTuple):
    """Kernel-layout sphere rows, built once per query."""

    spheres: torch.Tensor  # [S_pad, 4] f32: cx cy cz |c|^2-r^2
    num_spheres: int


def prep_sphere_search(scene: SphereScene) -> SearchSpheres:
    """The TPU kernel's sweep columns (prep_spheres), as float4 rows and
    detached: inactive slots get a +BIG cterm bias (never hit); padding
    slots sit at 1e9 with a BIG cterm."""
    with torch.no_grad():
        c = scene.center
        s = c.shape[0]
        c2r2 = (vm.length_squared(c) - scene.radius * scene.radius
                + torch.where(scene.active, 0.0, BIG))
        s_pad = max(-(-s // CHUNK_S) * CHUNK_S, CHUNK_S)
        pad = lambda x, v: torch.nn.functional.pad(x, (0, s_pad - s), value=v)
        rows = torch.stack([pad(c[:, 0], 1.0e9), pad(c[:, 1], 1.0e9),
                            pad(c[:, 2], 1.0e9), pad(c2r2, BIG)], dim=1)
    return SearchSpheres(rows.contiguous(), s)


def sphere_search(scene: SphereScene, origins: torch.Tensor,
                  directions: torch.Tensor, t_min: float, *,
                  interpret: bool = False, alive=None, exclude=None):
    """Closest-hit search of rays origins/directions [N, 3]: (t [N] f32,
    BIG = miss; idx [N] i32), detached. alive: optional [N] bool; dead
    lanes read (BIG, 0)."""
    if exclude is not None:
        raise NotImplementedError(
            "the per-lane exclude operand of the sphere search is not ported "
            "yet: ROADMAP Queue A item 8")
    if scene.num_spheres >= MIN_CHUNKS_FOR_CULLING * CHUNK_S:
        raise NotImplementedError(
            f"the sphere search of {scene.num_spheres} >= "
            f"{MIN_CHUNKS_FOR_CULLING * CHUNK_S} slots is the cluster-culled "
            "kernel A6, not ported yet: ROADMAP Queue A item 12")
    with torch.no_grad():
        n = origins.shape[0]
        dev = origins.device
        if origins.shape != (n, 3) or directions.shape != (n, 3):
            raise ValueError("origins and directions must be [N, 3]")
        if origins.dtype != torch.float32 or \
                directions.dtype != torch.float32:
            raise ValueError("origins and directions must be float32")
        rays = tuple(x[:, k].contiguous()
                     for x in (origins, directions) for k in range(3))
        if alive is None:
            alive = torch.ones(n, dtype=torch.bool, device=dev)
        alive = alive.contiguous()
        if alive.dtype != torch.bool or alive.shape != (n,) or \
                alive.device != dev:
            raise ValueError("alive must be an [N] bool tensor on the rays' "
                             "device")
        if n == 0 or n >= 2 ** 31:
            raise ValueError(f"sphere_search takes 0 < N < 2^31 rays, got {n}")
        return sphere_search_flat(prep_sphere_search(scene), *rays, alive,
                                  t_min, interpret=interpret)


@torch.no_grad()
def sphere_search_flat(tables: SearchSpheres, ox, oy, oz, dx, dy, dz, alive,
                       t_min: float, *, interpret: bool = False):
    """The search on prepared rows and flat contiguous [N] f32 ray
    components with an [N] bool alive mask: the kernel for CUDA tensors,
    the plain version for CPU tensors or with interpret=True."""
    dev = ox.device
    if tables.spheres.device != dev:
        raise ValueError(f"scene is on {tables.spheres.device}, rays on "
                         f"{dev}")
    rays = (ox, oy, oz, dx, dy, dz)
    if interpret or dev.type == "cpu":
        return sphere_search_plain(tables, *rays, alive, t_min)
    if dev.type != "cuda":
        raise ValueError(f"sphere_search runs on cpu or cuda tensors, "
                         f"got {dev}")
    return _launch(tables, rays, alive, float(t_min))


def _launch(tables: SearchSpheres, rays, alive, t_min: float):
    global launches
    lib = cuda_build.load_library()
    dev = rays[0].device
    n = rays[0].shape[0]
    if not all(x.is_contiguous() for x in (*rays, alive)):
        raise ValueError("kernel operands must be contiguous")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    if tables.spheres.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    with torch.cuda.device(dev):
        err = lib.qtrt_sphere_search(
            *(x.data_ptr() for x in rays), alive.data_ptr(),
            tables.spheres.data_ptr(), tables.spheres.shape[0],
            tables.num_spheres, t_min, n, t.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sphere search kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return t, idx


def sphere_search_plain(tables: SearchSpheres, ox, oy, oz, dx, dy, dz,
                        alive, t_min: float, slice_rays: int = PLAIN_SLICE):
    """Plain PyTorch version of A5: the A2 sweep (``fused_hit._sweep``, the
    expanded-form quadratic and min-then-match) over the padded table, in
    [slice_rays, S_pad] blocks; padding ids read back as 0."""
    n = ox.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=ox.device)
    idx = torch.empty(n, dtype=torch.int32, device=ox.device)
    for lo in range(0, n, slice_rays):
        sl = slice(lo, min(n, lo + slice_rays))
        t_best, best, _ = _sweep(tables.spheres, ox[sl], oy[sl], oz[sl],
                                 dx[sl], dy[sl], dz[sl], float(t_min))
        best = torch.where(best >= tables.num_spheres, 0, best)
        t[sl] = torch.where(alive[sl], t_best, BIG)
        idx[sl] = torch.where(alive[sl], best, 0)
    return t, idx
