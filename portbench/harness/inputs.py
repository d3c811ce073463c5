"""The benchmark's own inputs, made from a configuration and a seed: the
scene as plain float32 arrays (spheres, an optional triangle mesh), the
camera's parameters, the frame keys and the sampled pixels. Both the port
and the reference are handed these, and nothing the port derives."""

from __future__ import annotations

import numpy as np
import torch

from . import manifest
from ..reference import rng

TARGET_FOLD = 0xFFFFFFFF      # the key of a training target: never a step's


def _sphere_arrays(rows) -> dict:
    f32 = lambda x: np.asarray(x, np.float64).astype(np.float32)
    return {"center": f32([r[0] for r in rows]),
            "radius": f32([r[1] for r in rows]),
            "mat": np.asarray([r[2] for r in rows], np.int64),
            "albedo": f32([r[3] for r in rows]),
            "fuzz": f32([r[4] for r in rows]),
            "ior": f32([r[5] for r in rows]),
            "emission": f32([r[6] for r in rows])}


def scene_inputs(scene_cfg: dict, overrides: dict | None = None) -> dict:
    """{"spheres": {field: array}, "mesh": None or {field: array}}: the
    scene of scene_cfg["kind"] (a file under portbench/scenes), rounded to
    float32. overrides: {"albedo": {index: rgb}, "emission": {index: rgb}}
    replaces single spheres' values (a training run's starting point)."""
    raw = manifest.scene_kind(scene_cfg["kind"]).build(scene_cfg)
    spheres = _sphere_arrays(raw["spheres"])
    for fld, rows in (overrides or {}).items():
        for idx, val in rows.items():
            spheres[fld][int(idx)] = np.asarray(val, np.float32)
    mesh = raw.get("mesh")
    if mesh is not None:
        mesh = {k: (np.asarray(v, np.int64) if k in ("faces", "mat")
                    else np.asarray(v, np.float64).astype(np.float32))
                for k, v in mesh.items()}
    return {"spheres": spheres, "mesh": mesh}


def base_key(seed: int) -> torch.Tensor:
    return rng.seed_key(seed)


def unit_keys(seed: int, count: int) -> torch.Tensor:
    """[count, 2] key words of frames or steps 0..count-1:
    fold_in(key(seed), k)."""
    return rng.fold_in(base_key(seed), torch.arange(count))


def target_key(seed: int) -> torch.Tensor:
    return rng.fold_in(base_key(seed), TARGET_FOLD)


def sample_pixels(seed: int, num_pixels: int, count: int) -> np.ndarray:
    """count distinct flat pixel indices drawn from the seed, sorted."""
    g = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 1])
    return np.sort(g.choice(num_pixels, size=min(count, num_pixels),
                            replace=False))


def sample_units(seed: int, completed: int, count: int) -> list[int]:
    """count distinct indices of completed frames or steps drawn from the
    seed, always with the last one completed."""
    if completed <= 0:
        return []
    g = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 2])
    picks = set(g.choice(completed, size=min(count, completed),
                         replace=False).tolist())
    picks.discard(completed - 1)
    return sorted(list(picks)[:max(count - 1, 0)] + [completed - 1])
