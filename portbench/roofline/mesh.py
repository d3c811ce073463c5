"""Frozen rule: the work of a closest-hit query against a triangle mesh, on
the reference's own wavefronts, whatever kernel implements it.

The rule builds its own BVH: triangles sorted along a 3-D Morton curve of
their centroids, LEAF to a leaf, and a complete binary tree over the leaves
(heap order, leaves padded to a power of two with empty boxes). It counts
the tests that any walk of that tree must make once it holds the ray's
closest hit: the root's box, both children's boxes (BOX_OPS operations a
box) of every node whose box the ray enters between t_min and its closest
hit (the sphere hit caps it), and the triangles (TRI_OPS each,
Moller-Trumbore) of every leaf it enters so. Bytes: each live ray's
origin, direction and cap in (28) and its hit out (8); the node boxes (32)
and the triangles (36) once a wavefront. Counted on every STRIDE-th pixel
and scaled by STRIDE; level by level over (ray, node) pairs, so a
wavefront costs one pass a tree level.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _peaks
from . import sphere_hit as _sph

KERNELS = ("first_cluster_kernel", "mesh_search_kernel",
           "mesh_search_mxu_kernel", "crossing_lists_kernel",
           "pair_hits_kernel", "bvh_walk_kernel")
STRIDE = 64
LEAF = 4
BOX_OPS = 20
TRI_OPS = 45
RAY_BYTES = 28 + 8
NODE_BYTES = 32
TRI_BYTES = 36


def build(inputs: dict, device, dtype) -> dict:
    """The rule's BVH: node boxes "lo", "hi" [2L, 3] by heap index (leaves
    at L..2L-1), "valid" [L*LEAF] triangle slots, "n_leaf" L, and "order",
    the input index of each slot's triangle."""
    me = inputs["mesh"]
    verts = np.asarray(me["vertices"], np.float64)
    tri = verts[np.asarray(me["faces"], np.int64)]          # [F, 3, 3]
    order = _sph.morton_order(tri.mean(axis=1))
    tri = tri[order]
    f = tri.shape[0]
    leaves = -(-f // LEAF)
    n_leaf = 1 << max(0, (leaves - 1).bit_length())
    valid = np.arange(n_leaf * LEAF) < f
    t_lo = np.full((n_leaf * LEAF, 3), np.inf)
    t_hi = np.full((n_leaf * LEAF, 3), -np.inf)
    t_lo[:f], t_hi[:f] = tri.min(axis=1), tri.max(axis=1)
    lo = np.full((2 * n_leaf, 3), np.inf)
    hi = np.full((2 * n_leaf, 3), -np.inf)
    lo[n_leaf:] = t_lo.reshape(n_leaf, LEAF, 3).min(axis=1)
    hi[n_leaf:] = t_hi.reshape(n_leaf, LEAF, 3).max(axis=1)
    for i in range(n_leaf - 1, 0, -1):
        lo[i] = np.minimum(lo[2 * i], lo[2 * i + 1])
        hi[i] = np.maximum(hi[2 * i], hi[2 * i + 1])
    t = lambda x: torch.as_tensor(x, device=device, dtype=dtype)
    return {"lo": t(lo), "hi": t(hi), "n_leaf": n_leaf, "order": order,
            "valid": torch.as_tensor(valid, device=device)}


def walk(tree, o, d, t_hit, t_min):
    """(boxes tested, triangles tested, [(ray, leaf)] entered) of rays [R]
    whose closest hits lie at t_hit."""
    lo, hi, n_leaf = tree["lo"], tree["hi"], tree["n_leaf"]
    ray = torch.arange(o.shape[0], device=o.device)
    node = torch.ones_like(ray)
    boxes = ray.numel()
    while True:
        blo, bhi = lo[node], hi[node]
        inside = (blo <= bhi).all(dim=1) & _sph.slab(blo, bhi, o[ray],
                                                      d[ray], t_min,
                                                      t_hit[ray])
        ray, node = ray[inside], node[inside]
        if node.numel() == 0 or int(node[0]) >= n_leaf:
            break
        ray = torch.cat([ray, ray])
        node = torch.cat([2 * node, 2 * node + 1])
        boxes += node.numel()
    slots = (node - n_leaf)[:, None] * LEAF + torch.arange(
        LEAF, device=o.device)
    tris = int(tree["valid"][slots].sum())
    return boxes, tris, (ray, node)


def count(waves: list, inputs: dict, t_min: float = 1e-3):
    """[(live rays, boxes tested, triangles tested)] of each wavefront."""
    out, tree = [], None
    for w in waves:
        o, d = w["o"], w["d"]
        if tree is None:
            tree = build(inputs, o.device, o.dtype)
        boxes, tris, _ = walk(tree, o, d, w["t_hit"], t_min)
        out.append((o.shape[0], boxes, tris))
    return out, tree


def bound_s(waves: list, inputs: dict, stride: int) -> float:
    counts, tree = count(waves, inputs)
    if tree is None:
        return 0.0
    nodes = tree["lo"].shape[0] - 1
    tri_slots = int(tree["valid"].sum())
    total = 0.0
    for rays, boxes, tris in counts:
        flops = stride * (BOX_OPS * boxes + TRI_OPS * tris)
        nbytes = stride * rays * RAY_BYTES + nodes * NODE_BYTES \
            + tri_slots * TRI_BYTES
        total += _peaks.launch_s(flops, nbytes)
    return total
