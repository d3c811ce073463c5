"""Host BVH build and its flattened escape-index layout (counterpart of
``qt_raytracer_tpu.accel.bvh``, numpy only).

The tree is flattened to SoA arrays in depth-first order with escape
indices: a hit on node i continues to i + 1 (its first child), a miss jumps
to escape[i] (the next subtree to the right). Leaves hold contiguous runs of
reordered primitives. The numpy builder splits the largest-extent axis at the
centroid median; the native C++ builder (``runtime/native_bvh``) uses binned
SAH. Mesh building reads ``prim_order`` and the root box; ``validate_bvh``
checks a built tree's invariants.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np


class FlatBVH(NamedTuple):
    """SoA BVH of M nodes in DFS order (numpy arrays).

    leaf nodes: prim_count > 0, prims in [prim_start, prim_start+prim_count)
    inner nodes: prim_count == 0, first child at i+1, sibling via escape.
    escape[i]: node index to jump to when box i is missed (M = "done").
    """

    bbox_min: np.ndarray     # [M, 3] f32
    bbox_max: np.ndarray     # [M, 3] f32
    escape: np.ndarray       # [M] i32
    prim_start: np.ndarray   # [M] i32
    prim_count: np.ndarray   # [M] i32
    prim_order: np.ndarray   # [P] i32: original prim id at sorted position


def build_bvh(bb_min: np.ndarray, bb_max: np.ndarray,
              max_leaf: int = 4) -> FlatBVH:
    """Median-split build from per-primitive AABBs [P,3]."""
    p = bb_min.shape[0]
    if p == 0:
        raise ValueError("BVH requires at least one primitive")
    centroids = 0.5 * (bb_min + bb_max)
    nodes = []  # [bmin, bmax, prim_start, prim_count, right child]
    out_order = np.empty(p, np.int64)
    cursor = 0

    def rec(ids) -> int:
        nonlocal cursor
        my = len(nodes)
        nodes.append([bb_min[ids].min(0), bb_max[ids].max(0), -1, 0, None])
        if len(ids) <= max_leaf:
            nodes[my][2] = cursor
            nodes[my][3] = len(ids)
            out_order[cursor:cursor + len(ids)] = ids
            cursor += len(ids)
            return my
        axis = int(np.argmax(nodes[my][1] - nodes[my][0]))
        med = np.argsort(centroids[ids, axis], kind="stable")
        half = len(ids) // 2
        rec(ids[med[:half]])
        nodes[my][4] = rec(ids[med[half:]])
        return my

    rec(np.arange(p))

    m = len(nodes)
    escape = np.full(m, m, np.int32)

    def fill_escape(i: int, esc: int) -> None:
        escape[i] = esc
        if nodes[i][3] == 0:  # inner: children are i+1 and the right child
            right = nodes[i][4]
            fill_escape(i + 1, right)
            fill_escape(right, esc)

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * m + 100))
    try:
        fill_escape(0, m)
    finally:
        sys.setrecursionlimit(old)

    return FlatBVH(
        bbox_min=np.stack([n[0] for n in nodes]).astype(np.float32),
        bbox_max=np.stack([n[1] for n in nodes]).astype(np.float32),
        escape=escape,
        prim_start=np.array([n[2] for n in nodes], np.int32),
        prim_count=np.array([n[3] for n in nodes], np.int32),
        prim_order=out_order.astype(np.int32))


def validate_bvh(bvh: FlatBVH, bb_min: np.ndarray, bb_max: np.ndarray) -> None:
    """Structural invariants (used by tests): every primitive in exactly one
    leaf run, each leaf box holding its primitives' boxes, and every escape
    pointing forward, at most M."""
    m = len(bvh.escape)
    p = len(bvh.prim_order)
    assert sorted(bvh.prim_order.tolist()) == list(range(p))
    covered = np.zeros(p, bool)
    for i in np.nonzero(bvh.prim_count > 0)[0]:
        s, c = int(bvh.prim_start[i]), int(bvh.prim_count[i])
        assert not covered[s:s + c].any()
        covered[s:s + c] = True
        ids = bvh.prim_order[s:s + c]
        assert (bb_min[ids] >= bvh.bbox_min[i] - 1e-5).all()
        assert (bb_max[ids] <= bvh.bbox_max[i] + 1e-5).all()
    assert covered.all()
    assert (bvh.escape > np.arange(m)).all() and (bvh.escape <= m).all()
