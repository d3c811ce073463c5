"""The frozen roofline rules on hand-counted tiny scenes."""

import numpy as np
import pytest
import torch

from portbench.harness import manifest
from portbench.reference import tracer

sphere_rule = manifest.roofline_rule("sphere_hit")
mesh_rule = manifest.roofline_rule("mesh")


def _spheres(centers, radius=1.0):
    c = np.asarray(centers, np.float32)
    return {"spheres": {"center": c, "radius": np.full(len(c), radius,
                                                       np.float32)}}


def _wave(o, d, t_sphere=None):
    o = torch.tensor(o, dtype=torch.float64)
    d = torch.tensor(d, dtype=torch.float64)
    t = torch.full((o.shape[0],), float("inf"), dtype=torch.float64) \
        if t_sphere is None else torch.tensor(t_sphere, dtype=torch.float64)
    return {"o": o, "d": d, "t_sphere": t}


def test_sphere_rule_one_group():
    inp = _spheres([[0, 0, -5], [3, 0, -5]])
    wave = _wave([[0, 0, 0], [0, 0, 0]], [[0, 0, -1], [0, 1, 0]])
    # One group of two: both rays test its box, the first opens it.
    assert sphere_rule.count([wave], inp) == [(2, 2, 2)]
    flops = 20 * 2 + 25 * 2 + 100 * 2
    nbytes = 2 * 32 + 2 * 32 + 24
    assert sphere_rule.bound_s([wave], inp, 1) == pytest.approx(
        max(flops / 67e12, nbytes / 3.35e12))


def test_sphere_rule_gates_on_the_running_hit(monkeypatch):
    monkeypatch.setattr(sphere_rule, "GROUP", 1)
    # Morton order by z: C (z=-50), B (-20), A (-5). Looking down -z from
    # the origin every group opens (each box starts before the running
    # hit); looking up +z from z=-60, C's hit at t=9 closes B and A.
    inp = _spheres([[0, 0, -5], [0, 0, -20], [0, 0, -50]])
    wave = _wave([[0, 0, 0], [0, 0, -60]], [[0, 0, -1], [0, 0, 1]])
    assert sphere_rule.count([wave], inp) == [(2, 6, 4)]


def _strip(n):
    """n triangles side by side along x in the plane z = 0."""
    v, f = [], []
    for i in range(n):
        v += [[i, 0, 0], [i + 0.5, 0, 0], [i, 0.5, 0]]
        f.append([3 * i, 3 * i + 1, 3 * i + 2])
    v = np.asarray(v, np.float32)
    f = np.asarray(f)
    k = len(f)
    return {"spheres": {"center": np.full((1, 3), 1e6, np.float32),
                        "radius": np.ones(1, np.float32),
                        "mat": np.zeros(1, int),
                        "albedo": np.zeros((1, 3), np.float32),
                        "fuzz": np.zeros(1, np.float32),
                        "ior": np.ones(1, np.float32),
                        "emission": np.zeros((1, 3), np.float32)},
            "mesh": {"vertices": v, "faces": f, "mat": np.zeros(k, int),
                     "albedo": np.full((k, 3), 0.5, np.float32),
                     "fuzz": np.zeros(k, np.float32),
                     "ior": np.ones(k, np.float32),
                     "emission": np.zeros((k, 3), np.float32)}}


def test_mesh_rule_hand_counted_walk():
    inp = _strip(9)       # leaves of 4: 3 leaves in a tree of 4 (nodes 4-7)
    tree = mesh_rule.build(inp, "cpu", torch.float64)
    assert tree["n_leaf"] == 4
    wave = _wave([[8.2, 0.2, 5.0], [-3.0, 0.2, 5.0]],
                 [[0, 0, -1], [0, 0, -1]])
    wave["t_hit"] = torch.tensor([5.0, float("inf")], dtype=torch.float64)
    # Ray 0: the root, nodes 2 (missed) and 3, leaves 6 (one triangle) and
    # 7 (empty): 5 boxes, 1 triangle. Ray 1 misses the root: 1 box.
    boxes, tris, (ray, leaf) = mesh_rule.walk(tree, wave["o"], wave["d"],
                                              wave["t_hit"], 1e-3)
    assert (boxes, tris) == (6, 1)
    assert ray.tolist() == [0] and leaf.tolist() == [6]
    counts, _ = mesh_rule.count([wave], inp)
    assert counts == [(2, 6, 1)]
    # A hit before the leaf's box closes it: the root and both children.
    wave["t_hit"] = torch.tensor([4.0, float("inf")], dtype=torch.float64)
    assert mesh_rule.walk(tree, wave["o"], wave["d"], wave["t_hit"],
                          1e-3)[:2] == (2, 0)


def test_mesh_rule_enters_the_closest_triangles_leaf():
    g = np.random.default_rng(3)
    verts = g.uniform(-1, 1, size=(60, 3)).astype(np.float32)
    faces = g.integers(0, 60, size=(40, 3))
    inp = _strip(1)
    inp["mesh"].update(vertices=verts, faces=faces,
                       mat=np.zeros(40, int),
                       albedo=np.full((40, 3), 0.5, np.float32),
                       fuzz=np.zeros(40, np.float32),
                       ior=np.ones(40, np.float32),
                       emission=np.zeros((40, 3), np.float32))
    o = torch.tensor(g.uniform(-2, 2, size=(200, 3)))
    d = torch.tensor(g.normal(size=(200, 3)))
    cap = torch.full((200,), float("inf"), dtype=torch.float64)
    sc = tracer.make_scene(inp, torch.float64, "cpu")
    t_ref, i_ref = tracer.mesh_closest(sc, o, d, 1e-3, cap)
    tree = mesh_rule.build(inp, "cpu", torch.float64)
    _, _, (ray, leaf) = mesh_rule.walk(tree, o, d, t_ref, 1e-3)
    slot = {int(k): s for s, k in enumerate(tree["order"])}
    entered = set(zip(ray.tolist(), leaf.tolist()))
    hits = torch.nonzero(i_ref >= 0).squeeze(1).tolist()
    assert hits
    for r in hits:
        want = tree["n_leaf"] + slot[int(i_ref[r])] // mesh_rule.LEAF
        assert (r, want) in entered
