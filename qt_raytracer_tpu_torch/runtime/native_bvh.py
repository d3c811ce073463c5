"""Native (C++ binned-SAH) BVH build, ctypes-bound; produces
``accel.bvh.FlatBVH``; and the Wavefront OBJ loader (counterpart of
``qt_raytracer_tpu.runtime.native_bvh``)."""

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


def load_obj(path: str):
    """Load a Wavefront OBJ through the native parser, or in Python when the
    native library is unavailable or refuses the file (the JAX package's
    behaviour; both parse alike).

    Returns (vertices [V,3] f32, faces [F,3] i32) as numpy arrays.
    """
    lib = load_native()
    if lib is not None:
        nv = np.zeros(1, np.int32)
        nt = np.zeros(1, np.int32)
        ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        if lib.qtrt_obj_count(path.encode(), ip(nv), ip(nt)) == 0 and nv[0] > 0:
            verts = np.empty((int(nv[0]), 3), np.float32)
            faces = np.empty((int(nt[0]), 3), np.int32)
            fp = verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            if lib.qtrt_obj_load(path.encode(), fp, ip(faces)) == 0:
                return verts, faces
    return _load_obj_python(path)


def _load_obj_python(path: str):
    """The OBJ parser in Python: ``v`` lines, and ``f`` lines of 3 or more
    indices (1-based, or negative from the end; ``v/vt/vn`` forms) fanned
    into triangles."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v" and len(parts) >= 4:
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif parts[0] == "f" and len(parts) >= 4:
                nv = len(verts)
                idx = []
                for tok in parts[1:]:
                    v = int(tok.split("/")[0])
                    idx.append(v - 1 if v > 0 else nv + v)
                for k in range(2, len(idx)):
                    faces.append([idx[0], idx[k - 1], idx[k]])
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 3))
