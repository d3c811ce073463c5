"""The two-level cluster gate of A4 (first crossed cluster,
``csrc/mesh_intersect.cu``) and A7 (crossing lists, ``csrc/mesh_pairs.cu``),
held bit for bit on the CPU in plain PyTorch, on seeded numpy rays.

Both kernels test the box of each run of ``GROUP_C`` consecutive clusters
(``MeshClusters.group_boxes``, ``prep_group_boxes``: the exact union of the
member boxes) and a group's members only when it passes.
``crossing_walk_gated_plain`` runs that walk, with a count of its tests;
here it is held against the ungated plain versions
(``first_crossed_cluster_plain``: c1 and c2; ``crossing_lists_plain``:
lists and counts at list widths 1, 6 and k) on the 48x48 terrain at
clusters of 4 and 1 rows, the one-cluster Cornell mesh, and terrain strips
of k = G - 1, G, G + 1 and 2G + 3 clusters; with seeded rays (caps and dead
lanes) and with rays made to sit on the gate's edges: direction components
of +-0.0 and +-1e-31 (the slab reciprocal's clamp) on rays that start on a
box face, rays that start inside a box, caps at a member box's entry, on
either side of the slacked cap's boundary and at its 1e37 clamp, and t_min
at a box's entry. The group boxes must hold the cluster boxes: a box
moved past its group's box with the group boxes left stale loses
crossings, and ``with_cluster_boxes`` rebuilds them; the kernels' group
size (``csrc/mesh_common.cuh``) is ``GROUP_C``. This module imports no
JAX; ``tests/test_torch_cuda.py`` holds the kernels on the card to the
same rays.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from qt_raytracer_tpu_torch.kernels import mesh_intersect as mi
from qt_raytracer_tpu_torch.kernels import mesh_pairs as mp
from qt_raytracer_tpu_torch.models import meshes
from torch_helpers import _one_thread  # noqa: F401

T_MIN = 1e-3
BIG = mi.BIG
G = mi.GROUP_C


def strip_clusters(k: int, device="cpu"):
    """A terrain strip of exactly 128 k triangles (8 x 8k quads) in clusters
    of one row: k clusters."""
    world = meshes.terrain_world(9, 8 * k + 1, seed=k, builder="numpy",
                                 device="cpu")
    mc = mi.prep_mesh_clusters(world.mesh, cluster_rows=1)
    assert mc.k == k
    return mc if device == "cpu" else mc_to(mc, device)


def mc_to(mc, device):
    """mc with every table on device."""
    return mc._replace(**{f: getattr(mc, f).to(device) for f in (
        "tri_planes", "box_planes", "row_boxes", "group_boxes", "root_lo",
        "root_hi")})


def gate_worlds(device="cpu"):
    """The meshes of the gate's cases, by name: cluster counts 1, G - 1,
    G, G + 1, 2G + 3, 9 (the 48x48 terrain in clusters of 4 rows) and 35
    (in clusters of 1 row)."""
    terrain = meshes.terrain_world(48, 48, builder="numpy", device="cpu").mesh
    cornell = meshes.cornell_box_world(builder="numpy", device="cpu").mesh
    out = {"cornell_mesh": mi.prep_mesh_clusters(cornell),
           "terrain48": mi.prep_mesh_clusters(terrain),
           "terrain48_rows1": mi.prep_mesh_clusters(terrain, cluster_rows=1)}
    for k in (G - 1, G, G + 1, 2 * G + 3):
        out[f"strip_k{k}"] = strip_clusters(k)
    return {name: mc_to(mc, device) for name, mc in out.items()}


WORLDS = ["cornell_mesh", "terrain48", "terrain48_rows1", f"strip_k{G - 1}",
          f"strip_k{G}", f"strip_k{G + 1}", f"strip_k{2 * G + 3}"]


def seeded_rays(mc, n: int, seed: int):
    """n rays from around the root box, 70% alive, half capped inside it:
    (six [n] f32 components, alive, cap), on the CPU."""
    rng = np.random.default_rng(seed)
    lo, hi = mc.root_lo.cpu().numpy(), mc.root_hi.cpu().numpy()
    o = rng.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    alive = rng.random(n) < 0.7
    cap = np.where(rng.random(n) < 0.5, rng.uniform(0.2, 2.0, n),
                   BIG).astype(np.float32)
    return _as_torch(o, d, alive, cap)


def _as_torch(o, d, alive, cap):
    comps = [torch.from_numpy(np.ascontiguousarray(x[:, a], dtype=np.float32))
             for x in (o, d) for a in range(3)]
    return comps, torch.from_numpy(np.asarray(alive)), \
        torch.from_numpy(np.asarray(cap, dtype=np.float32))


def _gate_cap(t):
    return torch.clamp_max(t * 1.0001 + 1e-4, 1e37)


def _cap_at(enter):
    """The f32 caps t whose slacked cap min(t * 1.0001 + 1e-4, 1e37) is the
    first at or above enter, and the one just below it."""
    t = torch.clamp_min((enter - 1e-4) / 1.0001, 0.0)
    up, down = torch.tensor(BIG), torch.tensor(-BIG)
    for _ in range(64):
        t = torch.where(_gate_cap(t) < enter, torch.nextafter(t, up), t)
        below = torch.nextafter(t, down)
        t = torch.where(_gate_cap(below) >= enter, below, t)
    return t, torch.nextafter(t, down)


def adversarial_rays(mc, seed: int):
    """Rays on the gate's edges, all alive: (components, alive, cap).

    - On each face of each cluster box (the point of the face at the box's
      centre in the other two axes), with the face's direction component
      +0.0, -0.0, +1e-31 or -1e-31 and the others random: the slab
      reciprocal's clamp, and a slab interval that begins or ends at 0.
    - From each box's centre, in a random direction.
    - Aimed at each box's centre from outside the root box, capped at the
      box's entry, at the smallest cap whose slacked cap reaches it and at
      the cap just below that, at 1e37 and 1e37's neighbours, and at BIG."""
    rng = np.random.default_rng(seed)
    k = mc.k
    box = mc.box_planes[:, :k].cpu().numpy().T              # [k, 6]
    lo, hi = box[:, :3], box[:, 3:]
    mid = ((lo + hi) / 2).astype(np.float32)
    o, d, cap = [], [], []
    for c in range(k):
        for a in range(3):
            for face in (lo[c, a], hi[c, a]):
                for da in (0.0, -0.0, 1e-31, -1e-31):
                    p = mid[c].copy()
                    p[a] = face
                    v = rng.normal(size=3).astype(np.float32)
                    v[a] = np.float32(da)
                    o.append(p)
                    d.append(v)
                    cap.append(BIG if rng.random() < 0.5 else
                               rng.uniform(0.1, 2.0))
        for _ in range(4):
            o.append(mid[c])
            d.append(rng.normal(size=3).astype(np.float32))
            cap.append(rng.uniform(0.05, 1.0))
    # Aimed rays, capped at each box's own entry.
    rlo, rhi = mc.root_lo.cpu().numpy(), mc.root_hi.cpu().numpy()
    src = (rlo + rhi) / 2 + rng.normal(size=(k, 3)) \
        * (rhi - rlo).max() * 1.5
    src = src.astype(np.float32)
    aim = (mid - src).astype(np.float32)
    oa, da_ = torch.from_numpy(src), torch.from_numpy(aim)
    inv = tuple(mi.slab_inv(da_[:, a]) for a in range(3))
    own, _ = mi.slab_boxes(mc.box_planes[:, :k].cpu(),
                           tuple(oa[:, a] for a in range(3)), inv, T_MIN)
    at, below = _cap_at(own)
    clamp = torch.tensor(1e37)
    for caps in (own, at, below, clamp.expand(k),
                 torch.nextafter(clamp, torch.tensor(BIG)).expand(k),
                 torch.nextafter(clamp, torch.tensor(0.0)).expand(k),
                 torch.full((k,), BIG)):
        o.extend(src)
        d.extend(aim)
        cap.extend(caps.numpy())
    n = len(o)
    return _as_torch(np.stack(o), np.stack(d), np.ones(n, dtype=bool),
                     np.asarray(cap, dtype=np.float32))


def ray_cases(mc, kind: str):
    if kind == "seeded":
        return seeded_rays(mc, 1500, seed=mc.k)
    return adversarial_rays(mc, seed=mc.k + 1)


def check_walk(mc, rays, alive, cap, t_min):
    """The gated walk against the ungated plain versions, bit for bit, at
    every list width the kernels take; returns A7's walk at width k."""
    k = mc.k
    c1, c2 = mi.first_crossed_cluster_plain(mc, *rays, t_min, alive, cap,
                                            pair=True)
    one = mi.crossing_walk_gated_plain(mc, *rays, t_min, alive, cap, 1,
                                       stop=True)
    two = mi.crossing_walk_gated_plain(mc, *rays, t_min, alive, cap, 2,
                                       stop=True)
    assert torch.equal(one[0][:, 0], c1)
    assert torch.equal(two[0][:, 0], c1) and torch.equal(two[0][:, 1], c2)
    for c_max in sorted({1, min(6, k), k}):
        lists, ncross = mp.crossing_lists_plain(mc, *rays, t_min, alive, cap,
                                                c_max)
        walk = mi.crossing_walk_gated_plain(mc, *rays, t_min, alive, cap,
                                            c_max)
        assert torch.equal(walk[0], lists) and torch.equal(walk[1], ncross)
    ng = mi.num_groups(k)
    dead = ~alive
    for w in (one, two, walk):
        assert bool((w[2][dead] == 0).all() and (w[3][dead] == 0).all())
        assert bool((w[2] <= ng).all() and (w[3] <= k).all())
    # A7 tests every group; A4 stops at its first id, its pair at the next.
    assert bool((walk[2][alive] == ng).all())
    assert bool((one[2] + one[3] <= two[2] + two[3]).all())
    assert bool((two[2] + two[3] <= walk[2] + walk[3]).all())
    return walk


@pytest.fixture(scope="module")
def worlds():
    return gate_worlds()


@pytest.mark.parametrize("kind", ["seeded", "adversarial"])
@pytest.mark.parametrize("name", WORLDS)
def test_gated_walk_equals_ungated_plain(worlds, name, kind):
    mc = worlds[name]
    rays, alive, cap = ray_cases(mc, kind)
    walk = check_walk(mc, rays, alive, cap, T_MIN)
    crossed = walk[1][alive] > 0
    assert 0.0 < float(crossed.float().mean())
    if kind == "seeded" and mc.k > 2 * G:
        # The gate skips work: fewer tests than the k of the ungated walk.
        tests = (walk[2] + walk[3])[alive].float().mean()
        assert float(tests) < mc.k


@pytest.mark.parametrize("name", WORLDS)
def test_gated_walk_t_min_at_box_entry(worlds, name):
    # t_min at one ray's entry into each of a few boxes (the walk's t_min
    # is one scalar for all the rays).
    mc = worlds[name]
    rays, alive, cap = seeded_rays(mc, 512, seed=mc.k + 2)
    inv = tuple(mi.slab_inv(d) for d in rays[3:])
    enter, exit_ = mi._slab(mc.box_planes, 0, mc.k, rays[:3], inv, 0.0)
    crossing = (exit_ > enter) & (enter > 0.0) & alive[:, None]
    picks = torch.nonzero(crossing)[:3]
    assert picks.shape[0] > 0
    for ray, c in picks.tolist():
        check_walk(mc, rays, alive, cap, float(enter[ray, c]))


@pytest.mark.parametrize("name", WORLDS)
def test_group_boxes_hold_their_members(worlds, name):
    mc = worlds[name]
    k, ng = mc.k, mi.num_groups(mc.k)
    gb = mc.group_boxes
    assert gb.shape == (6, ng) and gb.dtype == torch.float32
    member = torch.arange(k) // G
    real = mc.box_planes[:, :k]
    # Every member inside its group's box, each face some member's face.
    assert bool((gb[:3, member] <= real[:3]).all())
    assert bool((gb[3:, member] >= real[3:]).all())
    for j in range(ng):
        mine = real[:, member == j]
        assert torch.equal(gb[:3, j], mine[:3].amin(1))
        assert torch.equal(gb[3:, j], mine[3:].amax(1))
    # The padding columns beyond k take part in no union: boxes that would
    # swallow everything there leave the group boxes as they are.
    wide = mc.box_planes.clone()
    wide[:3, k:], wide[3:, k:] = -BIG, BIG
    assert torch.equal(mi.prep_group_boxes(wide, k), gb)


def test_stale_group_boxes_are_refused(worlds):
    mc = worlds["terrain48_rows1"]
    rays, alive, cap = seeded_rays(mc, 64, seed=5)
    fewer = mc._replace(k=mc.k - 2 * G, box_planes=mc.box_planes.clone())
    for bad in (fewer, mc._replace(group_boxes=mc.group_boxes[:, :-1]),
                mc._replace(group_boxes=mc.group_boxes.double()),
                mc._replace(group_boxes=mc.group_boxes.T.contiguous().T)):
        with pytest.raises(ValueError, match="group_boxes"):
            mi.first_crossed_cluster(bad, *rays, T_MIN, alive, cap)
        with pytest.raises(ValueError, match="group_boxes"):
            mp.crossing_lists(bad, *rays, T_MIN, alive, cap, 1)


def moved_box(mc, c: int):
    """(stale, rebuilt): mc with cluster c's box widened to a 2,000-unit
    cube around the scene, which every live ray starts in and crosses; in
    stale the group boxes are left as they were, in rebuilt they come from
    with_cluster_boxes."""
    boxes = mc.box_planes.clone()
    boxes[:3, c], boxes[3:, c] = -1.0e3, 1.0e3
    return mc._replace(box_planes=boxes), mi.with_cluster_boxes(mc, boxes)


def test_edited_boxes_need_their_group_boxes(worlds):
    # What MeshClusters asks of group_boxes: with cluster 0's box moved
    # past its group's box and the group boxes left stale, the walk (as A4
    # and A7 run it on the card) misses the crossings of rays that miss the
    # group's old box, which the ungated plain versions find; rebuilt
    # through with_cluster_boxes, it equals them again.
    mc = worlds["terrain48_rows1"]
    rays, alive, cap = seeded_rays(mc, 1500, seed=7)
    stale, rebuilt = moved_box(mc, 0)
    c1 = mi.first_crossed_cluster_plain(stale, *rays, T_MIN, alive, cap)
    assert bool((c1[alive] == 0).all())
    walk = mi.crossing_walk_gated_plain(stale, *rays, T_MIN, alive, cap, 1,
                                        stop=True)[0][:, 0]
    assert bool((walk[alive] != 0).any())
    check_walk(rebuilt, rays, alive, cap, T_MIN)


def test_group_size_is_the_kernels():
    # The group boxes are built at GROUP_C; the kernels walk them at the
    # compile-time GROUP_C of csrc/mesh_common.cuh.
    src = (pathlib.Path(mi.__file__).parents[1] / "csrc"
           / "mesh_common.cuh").read_text()
    assert re.findall(r"constexpr int GROUP_C = (\d+);", src) == [str(G)]
    assert 32 % G == 0
