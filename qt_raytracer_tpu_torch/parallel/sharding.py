"""Rendering over an ("sp", "px") mesh of processes (counterpart of
``qt_raytracer_tpu.parallel.sharding``).

The JAX package shards one program over a device mesh with shard_map; here
each process (rank) of a ``torch.distributed`` group renders its own part,
one device per rank: NCCL between cards, gloo on the CPU (or on one card
shared by two ranks). Rank r sits at (r // px, r % px) of the mesh, row
major, as ``devices.reshape(sp, px)`` lays out JAX's.

    "sp" -- sample-parallel: each sp index renders spp / sp of the samples
    "px" -- pixel-parallel: each px index renders a contiguous pixel range

Every RNG key is a function of the global pixel and sample index, so "px"
gives the single-device image bit for bit, and "sp" only reassociates the
per-pixel sum of the spp samples (a few f32 ulps).

One collective assembles the image: an all-reduce over the whole mesh of a
zero-filled buffer of the padded pixel count into which each rank writes
its partial sum. It sums over "sp" and places the "px" ranges in one step
(x + 0 keeps px bit for bit), and hands every rank the whole image, the
user's view of JAX's global array. In training, the gradient of the scene
and camera tensors is summed over the mesh exactly once, as shard_map's
transpose does (see ``render_linear_sharded``).

A6's row rule: the cluster-culled sphere search (1,024 sphere slots or more
under ``intersector="pallas"``) decides per 128-ray row which chunks a row
sweeps, so a lane's result can depend on its row's other rays. A px range
that does not start on a multiple of 128 rays can therefore change bits
there, in the JAX package too. At 1080p the range of px = 2 is 1,036,800 =
8,100 x 128 rays, and the bits hold.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.config import RenderConfig
from ..core.render import accumulate_pixels, needs_grad
from ..core.world import World, tensors_of


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (sp, px) layout of the ranks of the default process group, one
    device each; this process is ``rank``. Without a process group it is a
    world of one, and its collectives have nothing to do."""

    sp: int
    px: int
    rank: int

    @property
    def shape(self) -> dict:
        return {"sp": self.sp, "px": self.px}

    @property
    def size(self) -> int:
        return self.sp * self.px

    @property
    def sp_index(self) -> int:
        return self.rank // self.px

    @property
    def px_index(self) -> int:
        return self.rank % self.px


def make_mesh(sp: int = 1, px: int | None = None) -> Mesh:
    """An ("sp", "px") mesh over every rank of the process group. px
    defaults to (#ranks / sp)."""
    world, rank = (dist.get_world_size(), dist.get_rank()) \
        if dist.is_initialized() else (1, 0)
    if px is None:
        px = world // sp
    if sp * px != world:
        raise ValueError(f"sp*px = {sp}*{px} != {world} devices")
    return Mesh(sp, px, rank)


def check_mesh(mesh) -> None:
    """Refuse a mesh= that is not this package's Mesh (None is no mesh)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a qt_raytracer_tpu_torch.parallel."
                        f"sharding.Mesh, got {type(mesh).__name__}")


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> None:
    """In-place sum of x over the mesh's ranks."""
    if mesh.size > 1 or dist.is_initialized():
        dist.all_reduce(x)


def _padded_pixels(cfg: RenderConfig, n_px: int) -> int:
    n = cfg.num_pixels
    return ((n + n_px - 1) // n_px) * n_px


class _ShareGrads(torch.autograd.Function):
    """Entry of the sharded render: the identity on the grad-requiring scene
    and camera tensors, plus a token for the exit. Its backward sums their
    gradients over the mesh in one all-reduce, so every rank holds the
    gradient of the whole image (shard_map's transpose). The token ties
    this node to the exit's, so every rank runs the all-reduce whenever a
    backward pass goes through the render."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        ctx.set_materialize_grads(True)
        return (tensors[0].new_zeros(()),) + tuple(t.view_as(t)
                                                   for t in tensors)

    @staticmethod
    def backward(ctx, _token_grad, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        _all_reduce(flat, ctx.mesh)
        out, lo = [], 0
        for g in grads:
            out.append(flat[lo:lo + g.numel()].view_as(g).to(g.dtype))
            lo += g.numel()
        return (None, *out)


class _Assemble(torch.autograd.Function):
    """Exit of the sharded render: the [n_padded, 3] image from every
    rank's partial sum of its pixel range [lo, lo + n), by one all-reduce.
    Its backward hands a rank the gradient of its own range alone."""

    @staticmethod
    def forward(ctx, partial, token, lo, n_padded, mesh):
        ctx.lo, ctx.n = lo, partial.shape[0]
        ctx.has_token = token is not None
        buf = partial.new_zeros((n_padded, 3))
        buf[lo:lo + ctx.n] = partial
        _all_reduce(buf, mesh)
        return buf

    @staticmethod
    def backward(ctx, grad):
        token_grad = grad.new_zeros(()) if ctx.has_token else None
        return grad[ctx.lo:ctx.lo + ctx.n], token_grad, None, None, None


def _with_tensors(obj, swap: dict):
    """obj (a SphereScene, TriangleMesh, Camera or World) with each tensor
    field t replaced by swap[id(t)] where present."""
    if obj is None:
        return None
    if isinstance(obj, World):
        return World(_with_tensors(obj.spheres, swap),
                     _with_tensors(obj.mesh, swap))
    new = {f.name: swap[id(getattr(obj, f.name))]
           for f in dataclasses.fields(obj)
           if id(getattr(obj, f.name)) in swap}
    return dataclasses.replace(obj, **new) if new else obj


def _share_grads(scene, camera, mesh: Mesh):
    """(scene, camera, token) through _ShareGrads."""
    tensors = [t for t in tensors_of(scene) + tensors_of(camera)
               if t.requires_grad]
    token, *shared = _ShareGrads.apply(mesh, *tensors)
    swap = {id(t): s for t, s in zip(tensors, shared)}
    return _with_tensors(scene, swap), _with_tensors(camera, swap), token


def render_linear_sharded(scene, camera, cfg: RenderConfig, key,
                          mesh: Mesh) -> torch.Tensor:
    """Distributed render_linear: sum of spp samples, [H, W, 3], on every
    rank. spp must be divisible by the "sp" axis size.

    Each rank renders its px range of the image padded to a multiple of px
    (the padding replays pixel 0 onward and is sliced off), for the samples
    sp_index * spp / sp + k, summed in ascending k from zeros: one sample
    at a time, whatever cfg.samples_per_batch says, as the JAX package's
    sharded scan does. So at sp = 1 the image is bit for bit
    ``render_linear`` at ``samples_per_batch=1`` (merged batches associate
    the sum otherwise). Inside a rank ``core.render.accumulate_pixels``
    renders the range as render_linear renders the image: in its chunks,
    the last one padded to their shape, each (chunk, sample) under
    ``torch.utils.checkpoint`` when gradients are on. The collectives stay
    outside the checkpointed regions, so a recompute never runs one. Every
    rank must call this with the same arguments, as every collective runs
    on all of them.

    Differentiable: ``torch.autograd.grad`` of any loss of the image gives
    every rank the single-device gradient (up to the order of the sum over
    ranks), the loss being taken on the whole image on each rank.
    """
    check_mesh(mesh)
    if cfg.spp % mesh.sp != 0:
        raise ValueError(f"spp={cfg.spp} not divisible by sp axis {mesh.sp}")
    local_spp = cfg.spp // mesh.sp
    n = cfg.num_pixels
    n_padded = _padded_pixels(cfg, mesh.px)
    shard = n_padded // mesh.px
    lo = mesh.px_index * shard
    token = None
    if needs_grad(scene, camera):
        scene, camera, token = _share_grads(scene, camera, mesh)
    pixel_index = torch.arange(lo, lo + shard, device=scene.device) % n
    partial = accumulate_pixels(scene, camera, cfg, key, pixel_index,
                                mesh.sp_index * local_spp, local_spp, 1)
    image = _Assemble.apply(partial, token, lo, n_padded, mesh)
    return image[:n].reshape(cfg.height, cfg.width, 3)


def replicate(tree, mesh: Mesh):
    """tree (a scene, world or camera dataclass, a dict of them or of
    tensors, or a tensor) with every tensor broadcast from rank 0: the
    counterpart of device_put_replicated. Every rank passes a tree of the
    same structure and shapes; requires_grad is kept."""
    check_mesh(mesh)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        out = tree.detach().clone()
        if mesh.size > 1 or dist.is_initialized():
            # Bool tensors travel as bytes: not every backend takes bool.
            dist.broadcast(out.view(torch.uint8) if out.dtype == torch.bool
                           else out, src=0)
        return out.requires_grad_(tree.requires_grad)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, World):
        return World(replicate(tree.spheres, mesh),
                     replicate(tree.mesh, mesh))
    return dataclasses.replace(tree, **{
        f.name: replicate(getattr(tree, f.name), mesh)
        for f in dataclasses.fields(tree)})
