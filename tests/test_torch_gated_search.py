"""The gates of the redesigned kernels A6 (cluster-culled sphere search,
``csrc/fused_hit.cu``) and A8 (pair hits, ``csrc/mesh_pairs.cu``), held bit
for bit on the CPU in plain PyTorch, on seeded numpy inputs.

- A6: ``sphere_search_clustered_gated_plain``, the kernel's gates (a 128-ray
  row opens a 64-slot chunk when a live lane crosses the chunk's AABB; a
  lane then sweeps a 32-slot group of an opened chunk when its own group
  gate passes under its running minimum), with a count of the groups each
  lane sweeps, against ``sphere_search_clustered_plain`` on every lane: on
  tied copies across lanes, groups and chunks, with a hollow sphere
  (negative radius) isolated in its group, at 18 and 33 chunks (more than
  one 32-bit word of the row's chunk mask), with dead lanes, a dead row and
  a ragged last row. (``test_torch_sphere_clustered.py`` holds it against
  the JAX package's Pallas kernel in interpret mode, beside the plain
  version it equals.)
- A8: ``pair_hits_gated_plain``, the kernel's per-pair row gate (row r of
  the tile's cluster is swept only when the slab test of the row's box
  passes with an entry at most min(t_best * 1.0001 + 1e-4, 1e37) of the
  pair's running hit), with a count of the rows each slot sweeps, against
  ``pair_hits_plain`` on every slot: clusters of g = 128 and 512 triangles
  on a 48x48 terrain and the 36-triangle Cornell mesh in one partial row;
  copies of triangles in the same row, the next row and another cluster;
  tiles that hold a single valid pair. (``test_torch_mesh_pairs.py`` holds
  the pair search with it in place of the pair sweep against the JAX
  package's ``mesh_search_pairs`` in interpret mode.)
"""

import numpy as np
import pytest
import torch

from qt_raytracer_tpu_torch import SceneBuilder
from qt_raytracer_tpu_torch.kernels import mesh_intersect as mi
from qt_raytracer_tpu_torch.kernels import mesh_pairs as mp
from qt_raytracer_tpu_torch.kernels import sphere_intersect as si
from qt_raytracer_tpu_torch.models import meshes
from torch_helpers import _one_thread, with_copies  # noqa: F401

T_MIN = 1e-3
BIG = si.BIG
LANE = 128


# ------------------------------------------------------------ A6
def _cell_scene(num_slots: int, seed: int):
    """num_slots spheres, chunk c of 64 slots in its own 4x4 cell of a
    grid (so the chunk boxes are tight and the row gate closes some), with
    copies of spheres 3, 70 and 200 at ids in another lane (+1), another
    32-slot group (+33) and another chunk (+64), and in slot 100 a sphere
    of radius -0.5 far above the rest of its group: a box from the signed
    radius leaves part of it out. Returns (scene, the ids to aim at)."""
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(num_slots):
        c = k // 64
        x0, z0 = (c % 6) * 4.0 - 12.0, (c // 6) * 4.0 - 12.0
        rows.append(((x0 + rng.uniform(0, 3), rng.uniform(0.3, 1.0),
                      z0 + rng.uniform(0, 3)), rng.uniform(0.1, 0.3)))
    sources = [3, 70, 200]
    for src in sources:
        rows[src] = ((rows[src][0][0], 1.6, rows[src][0][2]), 0.4)
        for off in (1, 33, 64):
            rows[src + off] = rows[src]
    rows[100] = ((rows[100][0][0], 3.2, rows[100][0][2]), -0.5)
    b = SceneBuilder()
    for c, r in rows:
        b.lambertian(c, r, (0.5, 0.5, 0.5))
    return b.build(pad_to=None, spatial_sort=False, device="cpu"), \
        sources + [100]


def _aimed_sphere_rays(scene, aim, n, seed):
    """n rays from above, half aimed at the centres of aim; about 10% of
    the lanes dead, and the third 128-ray row all dead."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-13.0, 13.0, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(4.0, 6.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    k = rng.random(n) < 0.5
    tgt = scene.center.numpy()[rng.choice(aim, int(k.sum()))]
    d[k] = tgt + rng.normal(scale=0.05, size=tgt.shape) - o[k]
    alive = rng.random(n) >= 0.1
    alive[256:384] = False
    rays = [torch.from_numpy(np.ascontiguousarray(x[:, a]))
            for x in (o, d) for a in range(3)]
    return rays, torch.from_numpy(alive)


@pytest.mark.parametrize("num_slots", [1152, 2112])
def test_clustered_gates_equal_the_row_gated_sweep(num_slots):
    scene, aim = _cell_scene(num_slots, seed=num_slots)
    tables = si.prep_sphere_search(scene)
    assert tables.num_chunks == num_slots // 64
    assert tables.boxes.shape == (num_slots // si.GROUP_S, 8)
    n = 2048 + 77                 # a ragged last row
    rays, alive = _aimed_sphere_rays(scene, aim, n, seed=num_slots + 1)
    want = si.sphere_search_clustered_plain(tables, *rays, alive, T_MIN)
    t, idx, groups = si.sphere_search_clustered_gated_plain(
        tables, *rays, alive, T_MIN)
    assert torch.equal(t, want[0]) and torch.equal(idx, want[1])
    assert bool((t[~alive] == BIG).all()) and bool((idx[~alive] == 0).all())
    assert bool((groups[~alive] == 0).all())
    # The gates skip work: some rows leave chunks closed, and a lane sweeps
    # far fewer groups than the table has.
    padded = torch.nn.functional.pad(alive, (0, (-n) % 128))
    rows = si.chunk_gate(tables, *[torch.nn.functional.pad(
        x, (0, (-n) % 128), value=1.0 if j == 5 else 0.0)
        for j, x in enumerate(rays)], padded, T_MIN)
    assert 0 < int(rows.sum()) < rows.numel()
    assert float(groups[alive].float().mean()) < 0.5 * tables.boxes.shape[0]
    # Ties were made, and the lowest id won them; the hollow sphere is hit.
    assert int(torch.isin(idx[alive], torch.tensor(aim[:3])).sum()) > 50
    assert int((idx[alive] == 100).sum()) > 10
    # The clustered search sweeps a subset of the slots of the monolithic
    # one: never a closer hit.
    mono = si.sphere_search_plain(tables, *rays, alive, T_MIN)
    assert bool((t[alive] >= mono[0][alive]).all())


# ------------------------------------------------------------ A8
@pytest.fixture(scope="module")
def pair_cases():
    rng = np.random.default_rng(23)
    terrain = meshes.terrain_world(48, 48, builder="numpy", device="cpu").mesh
    cornell = meshes.cornell_box_world(builder="numpy", device="cpu").mesh
    out = {}
    for name, mesh, rows in (("terrain48_g512", terrain, 4),
                             ("terrain48_g128", terrain, 1),
                             ("cornell_g36", cornell, 4)):
        mc = mi.prep_mesh_clusters(mesh, cluster_rows=rows)
        g, p = mc.tris_per_cluster, mesh.num_triangles
        # Copies in the same row (+1), the next row (+130: the next cluster
        # where g = 128) and another cluster (a padding slot of the last).
        if name == "cornell_g36":
            srcs, dsts = [0, 5, 17], [p + 1, p + 40, p + 70]
        else:
            srcs = [3, g + 40, 2 * g + 7]
            dsts = [4, g + 170, mc.k * g - 3]
        mc = with_copies(mc, mesh, list(zip(srcs, dsts)))
        n = 1024
        lo, hi = mc.root_lo.numpy(), mc.root_hi.numpy()
        if name == "cornell_g36":
            o = np.stack([rng.uniform(-0.95, 0.95, n),
                          rng.uniform(0.05, 1.95, n),
                          rng.uniform(0.8, 3.0, n)], 1).astype(np.float32)
        else:
            o = rng.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
            o[:, 1] += 1.5
        tp = mc.tri_planes.numpy()
        cen = (3 * tp[0:3] + tp[3:6] + tp[6:9]).T[srcs] / 3.0
        d = rng.normal(size=(n, 3)).astype(np.float32)
        aim = rng.random(n) < 0.5
        d[aim] = (cen[rng.integers(0, 3, int(aim.sum()))]
                  + rng.normal(scale=0.01, size=(int(aim.sum()), 3))
                  - o[aim])
        if name == "cornell_g36":
            d[~aim, 2] = -np.abs(d[~aim, 2])
        rays = [torch.from_numpy(np.ascontiguousarray(x[:, a].astype(
            np.float32))) for x in (o, d) for a in range(3)]
        alive = torch.from_numpy(rng.random(n) < 0.8)
        cap = torch.from_numpy(np.where(rng.random(n) < 0.5,
                                        rng.uniform(0.3, 3.0, n),
                                        BIG).astype(np.float32))
        lists, _ = mp.crossing_lists(mc, *rays, T_MIN, alive, cap,
                                     min(6, mc.k))
        ray_buf, gmap = mp.pair_slots(lists, mc.k)
        out[name] = (mc, rays, cap, ray_buf, gmap, srcs)
    return out


@pytest.mark.parametrize("name", ["terrain48_g512", "terrain48_g128",
                                  "cornell_g36"])
def test_row_gated_pair_sweep_equals_pair_hits_plain(pair_cases, name):
    mc, rays, cap, ray_buf, gmap, srcs = pair_cases[name]
    want = mp.pair_hits_plain(mc, *rays, cap, ray_buf, gmap, T_MIN)
    t, idx, rows = mp.pair_hits_gated_plain(mc, *rays, cap, ray_buf, gmap,
                                            T_MIN)
    assert torch.equal(t, want[0]) and torch.equal(idx, want[1])
    valid = ray_buf >= 0
    nrows = mc.tris_per_cluster // LANE
    assert bool((rows[~valid] == 0).all())
    assert int(rows.max()) <= nrows
    won = t < BIG
    assert 0.05 < float(won[valid].float().mean()) < 0.95
    # The copies' sources win their ties.
    assert int(torch.isin(idx[won], torch.tensor(srcs)).sum()) > 50
    if nrows > 1:
        # The gate skips rows: fewer than half of them per valid pair.
        assert float(rows[valid].float().mean()) < 0.5 * nrows
    # Blocks of tiles do not change the result.
    small = mp.pair_hits_gated_plain(mc, *rays, cap, ray_buf, gmap, T_MIN,
                                     slice_tiles=3)
    assert all(torch.equal(a, b) for a, b in zip(small, (t, idx, rows)))


@pytest.mark.parametrize("name", ["terrain48_g512", "cornell_g36"])
def test_row_gated_pair_sweep_single_valid_pair_tiles(pair_cases, name):
    # One valid pair per tile, at the first, a middle and the last slot,
    # beside tiles without one, on the first 24 tiles of the case's slots:
    # every slot as pair_hits_plain gives it.
    mc, rays, cap, ray_buf, gmap, _ = pair_cases[name]
    n = rays[0].shape[0]
    gmap = gmap[:24].contiguous()
    tiles = torch.full((gmap.shape[0], LANE), -1, dtype=torch.int64)
    for k in range(gmap.shape[0]):
        if k % 4 != 3:
            tiles[k, (0, 77, 127)[k % 3]] = (k * 131) % n
    ray_buf = tiles.reshape(-1).contiguous()
    want = mp.pair_hits_plain(mc, *rays, cap, ray_buf, gmap, T_MIN)
    got = mp.pair_hits_gated_plain(mc, *rays, cap, ray_buf, gmap, T_MIN)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[2] > 0).sum()) <= int((ray_buf >= 0).sum())
    assert bool((want[0] < BIG).any())
