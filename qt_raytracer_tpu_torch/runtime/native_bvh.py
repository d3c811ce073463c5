"""Native (C++ binned-SAH) BVH build, ctypes-bound; produces
``accel.bvh.FlatBVH`` (counterpart of ``qt_raytracer_tpu.runtime.native_bvh``;
the OBJ loader is ported with the CLI)."""

from __future__ import annotations

import ctypes

import numpy as np

from ..accel.bvh import FlatBVH
from .native_lib import load_native


def build_bvh_native(bb_min: np.ndarray, bb_max: np.ndarray,
                     max_leaf: int = 4) -> FlatBVH:
    lib = load_native()
    if lib is None:
        raise RuntimeError("native library unavailable")
    p = int(bb_min.shape[0])
    if p == 0:
        raise ValueError("BVH requires at least one primitive")
    bb_min = np.ascontiguousarray(bb_min, np.float32)
    bb_max = np.ascontiguousarray(bb_max, np.float32)
    cap = 2 * p  # worst case 2p-1 nodes
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    escape = np.empty(cap, np.int32)
    prim_start = np.empty(cap, np.int32)
    prim_count = np.empty(cap, np.int32)
    prim_order = np.empty(p, np.int32)

    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    m = lib.qtrt_build_bvh(fp(bb_min), fp(bb_max), p, int(max_leaf),
                           fp(node_min), fp(node_max), ip(escape),
                           ip(prim_start), ip(prim_count), ip(prim_order))
    if m <= 0:
        raise RuntimeError(f"qtrt_build_bvh failed ({m})")
    return FlatBVH(bbox_min=node_min[:m].copy(), bbox_max=node_max[:m].copy(),
                   escape=escape[:m].copy(), prim_start=prim_start[:m].copy(),
                   prim_count=prim_count[:m].copy(), prim_order=prim_order)
