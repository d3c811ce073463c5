"""Carry scene, mesh, world, camera, key, training state and progressive
state across from the JAX package.

Each takes the JAX package's values as numpy arrays (for example
``{f.name: np.asarray(getattr(scene, f.name)) for f in
dataclasses.fields(scene)}``, or ``np.asarray(jax.random.key_data(key))``),
so the two packages compute on identical inputs. Nothing here imports JAX.
Each takes ``device``: None is the CUDA card (and raises without one); the
tests pass ``"cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.mesh import TriangleMesh
from ..app.progressive import ProgressiveState
from ..core.camera import Camera
from ..core.scene import SphereScene
from ..core.world import World
from ..diff.inverse import TrainState, leaves
from ..runtime.device import resolve_device


def _from_arrays(cls, arrays: dict[str, np.ndarray], device):
    device = resolve_device(device)
    names = [f.name for f in dataclasses.fields(cls)]
    missing = sorted(set(names) - set(arrays))
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {missing}")
    return cls(**{n: torch.from_numpy(np.array(arrays[n], copy=True)).to(device)
                  for n in names})


def scene_from_arrays(arrays: dict[str, np.ndarray],
                      device=None) -> SphereScene:
    """SphereScene from numpy arrays named after its fields."""
    return _from_arrays(SphereScene, arrays, device)


def camera_from_arrays(arrays: dict[str, np.ndarray], device=None) -> Camera:
    """Camera from numpy arrays named after its fields."""
    return _from_arrays(Camera, arrays, device)


def mesh_from_arrays(arrays: dict[str, np.ndarray],
                     device=None) -> TriangleMesh:
    """TriangleMesh from numpy arrays named after its fields."""
    return _from_arrays(TriangleMesh, arrays, device)


def world_from_arrays(spheres: dict[str, np.ndarray],
                      mesh: dict[str, np.ndarray] | None,
                      device=None) -> World:
    """World from the numpy fields of its SphereScene and of its
    TriangleMesh (None for a world without a mesh)."""
    return World(scene_from_arrays(spheres, device),
                 None if mesh is None else mesh_from_arrays(mesh, device))


def key_from_words(words) -> torch.Tensor:
    """A PRNG key ([2] int64 tensor of uint32 words) from the key data of a
    JAX threefry key."""
    w = np.asarray(words).astype(np.uint64).reshape(-1)
    if w.shape != (2,) or int(w.max()) > 0xFFFFFFFF:
        raise ValueError(f"a key is two uint32 words, got {words!r}")
    return torch.from_numpy(w.astype(np.int64))


def _nested_tensors(tree: dict, device) -> dict:
    return {k: _nested_tensors(v, device) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in tree.items()}


def train_state_from_arrays(params: dict, mu: dict, nu: dict, count: int,
                            step: int, optimizer, device=None) -> TrainState:
    """The port's TrainState from a JAX one: params, and optax Adam's first
    and second moments mu and nu, as nested dicts of numpy arrays shaped
    like the port's params ({"scene": {...}, "camera": {...}}); count, the
    Adam step count; step, the TrainState step. optimizer: the factory the
    port's train step was built with (``diff.inverse.adam``); its Adam state
    is set to the moments and count, so one step of either package from
    this state takes the same update."""
    device = resolve_device(device)
    p = _nested_tensors(params, device)
    for _, t in leaves(p):
        t.requires_grad_(True)
    opt = optimizer(p)
    m, v = dict(leaves(_nested_tensors(mu, device))), \
        dict(leaves(_nested_tensors(nu, device)))
    for path, t in leaves(p):
        if m[path].shape != t.shape or v[path].shape != t.shape:
            raise ValueError(f"moments of {path} do not match its shape")
        opt.state[t] = {"step": torch.tensor(float(count)),  # Adam keeps it on the host
                        "exp_avg": m[path], "exp_avg_sq": v[path]}
    return TrainState(p, opt, int(step))


def progressive_state_from_arrays(accum, sample_count: int, seed: int,
                                  device=None) -> ProgressiveState:
    """The port's ProgressiveState from a JAX one: accum, the [H, W, 3]
    linear radiance sum (``np.asarray(state.accum)``), its sample count and
    seed. Set it as ``renderer.state`` and the next ``step`` continues the
    JAX render with the same samples."""
    accum = np.asarray(accum)
    if accum.ndim != 3 or accum.shape[2] != 3:
        raise ValueError(f"accum is [H, W, 3], got {accum.shape}")
    return ProgressiveState(
        accum=torch.from_numpy(np.array(accum, dtype=np.float32)).to(
            resolve_device(device)),
        sample_count=int(sample_count), seed=int(seed))
