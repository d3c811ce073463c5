"""Carry scene, mesh, world and camera state across from the JAX package.

Each takes the fields of the JAX package's dataclasses as numpy arrays (for
example ``{f.name: np.asarray(getattr(scene, f.name)) for f in
dataclasses.fields(scene)}``), so the two packages compute on identical
inputs. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.mesh import TriangleMesh
from ..core.camera import Camera
from ..core.scene import SphereScene
from ..core.world import World


def _from_arrays(cls, arrays: dict[str, np.ndarray], device):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = sorted(set(names) - set(arrays))
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {missing}")
    return cls(**{n: torch.from_numpy(np.array(arrays[n], copy=True)).to(device)
                  for n in names})


def scene_from_arrays(arrays: dict[str, np.ndarray],
                      device="cpu") -> SphereScene:
    """SphereScene from numpy arrays named after its fields."""
    return _from_arrays(SphereScene, arrays, device)


def camera_from_arrays(arrays: dict[str, np.ndarray], device="cpu") -> Camera:
    """Camera from numpy arrays named after its fields."""
    return _from_arrays(Camera, arrays, device)


def mesh_from_arrays(arrays: dict[str, np.ndarray],
                     device="cpu") -> TriangleMesh:
    """TriangleMesh from numpy arrays named after its fields."""
    return _from_arrays(TriangleMesh, arrays, device)


def world_from_arrays(spheres: dict[str, np.ndarray],
                      mesh: dict[str, np.ndarray] | None,
                      device="cpu") -> World:
    """World from the numpy fields of its SphereScene and of its
    TriangleMesh (None for a world without a mesh)."""
    return World(scene_from_arrays(spheres, device),
                 None if mesh is None else mesh_from_arrays(mesh, device))
