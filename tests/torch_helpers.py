"""What the port's test modules share; imports no JAX, so the card tests
(``tests/test_torch_cuda.py``) take it too.

- ``_one_thread``: PyTorch at one thread for the module that imports it by
  name (an autouse fixture). The port's CPU tests run small tensors: more
  threads gain nothing alone, and beside other test workers they only
  contend for the cores.
- ``with_copies``: a mesh's kernel tables with triangles copied over
  others, for ties made on purpose.
- ``mxu_adversarial``: triangles and rays on the edges of the tests of the
  bilinear-form search's TF32 filter.
- ``shade_inputs``: a ray state and a hit dict that reach every branch of a
  bounce's shading, for the shading kernel against its plain version.
"""

import numpy as np
import pytest
import torch

from qt_raytracer_tpu_torch.accel.mesh import build_mesh
from qt_raytracer_tpu_torch.kernels import mesh_intersect as mi


@pytest.fixture(scope="module", autouse=True)
def _one_thread(request):
    # After the module's own _fresh_jit_cache where it has one: that starts
    # PyTorch's thread pool before XLA's.
    if "_fresh_jit_cache" in request.fixturenames:
        request.getfixturevalue("_fresh_jit_cache")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def with_copies(mc, mesh, pairs):
    """mc with triangle src copied over triangle dst for each (src, dst),
    and the cluster, row and group boxes rebuilt around the new planes,
    with the padding prep_mesh_clusters gives them."""
    tp = mc.tri_planes.clone()
    mt = None if mc.mt_planes is None else mc.mt_planes.clone()
    for src, dst in pairs:
        tp[:, dst] = tp[:, src]
        if mt is not None:   # a triangle's factors are its own
            mt[:, dst] = mt[:, src]
    v0, e1, e2 = (tp[3 * a:3 * a + 3].T for a in range(3))
    eps = mi._box_eps(mesh)
    k, g = mc.k, mc.tris_per_cluster
    lo, hi = mi._padded_boxes(v0, e1, e2, k, eps)
    boxes = mc.box_planes.clone()
    boxes[:3, :k], boxes[3:, :k] = lo.T, hi.T
    lo_r, hi_r = mi._padded_boxes(v0, e1, e2, k * g // mi.LANE, eps)
    rows = torch.cat([lo_r.T, hi_r.T]).contiguous()
    return mi.with_cluster_boxes(
        mc._replace(tri_planes=tp.contiguous(), row_boxes=rows,
                    mt_planes=mt),
        boxes.contiguous())


HUGE = 1e19          # the edge of the triangle whose u underflows to -0


def _adversarial_triangles(rng):
    """[F, 3, 3] float64 vertices: unit-scale triangles, a shared edge,
    small triangles far from the origin (terrain-scale coordinates), tiny
    ones (|det| near 1e-12 for unit directions) and one of edge HUGE."""
    tris = []
    for _ in range(24):
        v0 = rng.uniform(-1.0, 1.0, 3)
        tris.append([v0, v0 + rng.normal(size=3) * 0.5,
                     v0 + rng.normal(size=3) * 0.5])
    a, b, c, d = (np.array(x, float) for x in
                  ([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]))
    tris += [[a + 3, b + 3, c + 3], [a + 3, c + 3, d + 3]]   # shared edge
    for off in (1e2, 1e3, 1e4):
        for _ in range(8):
            v0 = rng.uniform(-1.0, 1.0, 3) * off
            tris.append([v0, v0 + rng.normal(size=3) * 0.05,
                         v0 + rng.normal(size=3) * 0.05])
    for _ in range(8):
        v0 = rng.uniform(-1.0, 1.0, 3)
        tris.append([v0, v0 + rng.normal(size=3) * 1e-6,
                     v0 + rng.normal(size=3) * 1e-6])
    tris.append([[0.0, 0.0, 0.0], [HUGE, 0.0, 0.0], [0.0, HUGE, 0.0]])
    return np.asarray(tris, np.float64)


def mxu_adversarial(seed: int = 0, device="cpu"):
    """(mesh, rays, cap): a TriangleMesh of _adversarial_triangles (one
    cluster, BVH order) and rays, six float32 [N] components, with caps
    [N] float32, aimed at the triangles' vertices, edge midpoints, points
    just either side of an edge and centroids, from either side; grazing
    the plane; scaled so that |det| sits within a few ulps of 1e-12; with
    t at the t_min of 1e-3; a direction with a subnormal and a zero
    component; and the ray whose u is a negative below 2^-149 * det on the
    HUGE triangle, which rounds to -0.0 and so passes u >= 0. A third of
    the caps are BIG, the rest at the ray's own t (which the exact test
    then rejects) or one ulp above it, where the plain search finds it
    (set on the CPU, by mesh_search_plain(mt="mxu") with no cap); the
    last ray, whose u underflows, is uncapped."""
    rng = np.random.default_rng(seed)
    tris = _adversarial_triangles(rng)
    o_list, d_list = [], []

    def aim(origin, target, scale=1.0):
        o_list.append(origin)
        d_list.append((target - origin) * scale)

    for v in tris[:-1]:
        v0, e1, e2 = v[0], v[1] - v[0], v[2] - v[0]
        n = np.cross(e1, e2)
        n = n / np.linalg.norm(n)
        size = max(np.linalg.norm(e1), np.linalg.norm(e2))
        cen = v.mean(0)
        for side in (1.0, -1.0):
            o = cen + side * n * size * rng.uniform(0.5, 3.0) \
                + rng.normal(size=3) * size * 0.3
            for target in (*v, (v[0] + v[1]) / 2, (v[1] + v[2]) / 2,
                           (v[0] + v[2]) / 2, cen):
                aim(o, target)
            mid = (v[1] + v[2]) / 2
            out = mid - cen
            for eps in (-1e-7, 1e-7):      # just inside and outside an edge
                aim(o, mid + out * eps)
            # Grazing: nearly in the plane.
            aim(cen - e1 * 2.0, cen + n * size * 1e-6)
        # |det| = |d . n_raw| near 1e-12: scale a ray at the centroid.
        o = cen + n * size
        d0 = cen - o
        det = abs(np.dot(d0, np.cross(e1, e2)))
        for k in range(-3, 4):
            aim(o, cen, 1e-12 / det * (1.0 + k * 2.0 ** -22))
        # t at t_min = 1e-3: the origin 1e-3 before the centroid; and t = 0
        # (either sign): the origin on the triangle.
        dd = -n
        o_list.append(cen - dd * 1e-3)
        d_list.append(dd)
        for dd in (-n, n, rng.normal(size=3)):
            o_list.append(cen)
            d_list.append(dd)
    o_list.append(np.array([0.3, 0.2, 1.0]))
    d_list.append(np.array([1e-40, 0.0, -1.0]))
    # u = x / HUGE with x = -1e-30: -1e-49 rounds to -0.0.
    o_list.append(np.array([-1e-30, 0.5 * HUGE, 1.0]))
    d_list.append(np.array([0.0, 0.0, -1.0]))
    o = np.asarray(o_list, np.float32)
    d = np.asarray(d_list, np.float32)
    verts = tris.reshape(-1, 3)
    faces = np.arange(verts.shape[0]).reshape(-1, 3)
    mesh = build_mesh(verts, faces, builder="numpy", device="cpu")
    mc = mi.prep_mesh_clusters(mesh, mt="mxu")
    rays = [torch.from_numpy(np.ascontiguousarray(x[:, a]))
            for x in (o, d) for a in range(3)]
    n = o.shape[0]
    alive = torch.ones(n, dtype=torch.bool)
    t, _ = mi.mesh_search_plain(mc, *rays, 1e-3, alive,
                                torch.full((n,), mi.BIG), mt="mxu")
    pick = rng.integers(0, 3, n)
    cap = np.where(pick == 0, mi.BIG,
                   np.where(pick == 1, t.numpy(),
                            np.nextafter(t.numpy(), np.float32(np.inf))))
    cap = np.where(t.numpy() < mi.BIG, cap, mi.BIG).astype(np.float32)
    cap[-1] = mi.BIG              # the ray whose u underflows: uncapped
    cap = torch.from_numpy(cap)
    mesh = mesh.to(device) if device != "cpu" else mesh
    return mesh, [x.to(device) for x in rays], cap.to(device)


def shade_inputs(n: int, seed: int, depth_idx: int = 0, device="cpu"):
    """(RayState, hit dict) of n lanes for ``integrator_flat._shade``: the
    four materials and an unknown id, both faces, fuzz 0 and above, iors
    that give total internal reflection, misses, dead lanes, zero-length
    directions, normals that make the Lambertian degenerate guard fire
    (n = -random_unit_vector of the lane's own uniforms), and NaN, inf and
    -0.0 in the state and the hit. Built on the CPU from numpy."""
    from qt_raytracer_tpu_torch.core import sampling
    from qt_raytracer_tpu_torch.core.integrator_flat import RayState
    from qt_raytracer_tpu_torch.kernels.fused_hit import BIG

    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    unit = lambda v: v / np.linalg.norm(v, axis=1, keepdims=True)
    keys = rng.integers(0, 2 ** 32, n, dtype=np.int64)
    d = f32(rng.normal(size=(n, 3)) * rng.choice([1.0, 1e-3, 40.0], (n, 1)))
    d[rng.random(n) < 0.03] = 0.0                      # inv_len's guard
    nrm = f32(unit(rng.normal(size=(n, 3))))
    uni = sampling.stream_uniforms(torch.from_numpy(keys),
                                   sampling.STREAM_BOUNCE0 + depth_idx,
                                   sampling.UNIFORMS_PER_BOUNCE).numpy()
    zc = 1.0 - 2.0 * uni[:, 0]
    rr = np.sqrt(np.maximum(1.0 - zc * zc, 1e-20))
    phi = np.float32(2 * np.pi) * uni[:, 1]
    ru = f32(np.stack([rr * np.cos(phi), rr * np.sin(phi), zc], 1))
    degen = rng.random(n) < 0.05
    nrm[degen] = -ru[degen]                            # n + ru ~ 0
    mat = rng.choice([0, 1, 2, 3, 5], n, p=[0.3, 0.25, 0.3, 0.1, 0.05])
    ff = rng.integers(0, 2, n)
    fuzz = f32(np.where(rng.random(n) < 0.5, 0.0, rng.random(n)))
    ior = f32(rng.choice([1.5, 1.5, 2.4, 1.0, 0.0, -1.3], n))
    t = f32(np.where(rng.random(n) < 0.2, BIG, rng.uniform(0.01, 50.0, n)))
    tp = f32(rng.uniform(0.0, 1.0, (n, 3)))
    tp[rng.random(n) < 0.1] *= np.float32(1e-3)        # roulette's p floor
    rad = f32(rng.uniform(0.0, 3.0, (n, 3)))
    rad[rng.random(n) < 0.05] = -0.0
    state = {
        "o": f32(rng.uniform(-20, 20, (n, 3))), "d": d, "tp": tp, "rad": rad,
        "p": f32(rng.uniform(-20, 20, (n, 3))), "n": nrm,
        "a": f32(rng.random((n, 3))), "e": f32(rng.uniform(0, 8, (n, 3))),
    }
    # Non-finite entries in every field, a few lanes each.
    for x in state.values():
        for v in (np.nan, np.inf, -np.inf):
            x[rng.random(n) < 0.004, rng.integers(0, 3)] = v
    t[rng.random(n) < 0.01] = np.nan
    alive = rng.random(n) < 0.8
    col = lambda x, k: torch.from_numpy(np.ascontiguousarray(x[:, k]))
    o, dd, tt, rd = (state[k] for k in ("o", "d", "tp", "rad"))
    s = RayState(*(col(x, k) for x in (o, dd, tt, rd) for k in range(3)),
                 torch.from_numpy(alive), torch.full((n,), -1.0),
                 torch.from_numpy(keys), torch.arange(n))
    h = {"t": torch.from_numpy(t), "idx": torch.zeros(n, dtype=torch.int32),
         "mat": torch.from_numpy(mat.astype(np.int32)),
         "ff": torch.from_numpy(ff.astype(np.int32)),
         "fuzz": torch.from_numpy(fuzz), "ior": torch.from_numpy(ior),
         "rw": torch.zeros(n)}
    for name, x in (("p", state["p"]), ("n", state["n"]), ("a", state["a"]),
                    ("e", state["e"])):
        for k, ax in enumerate("xyz"):
            h[name + ax] = col(x, k)
    s = RayState(*(x.to(device) for x in s))
    return s, {k: v.to(device) for k, v in h.items()}
