"""C5: the cluster-culled sphere search (kernel A6) misses a hollow sphere
alone in its 64-slot chunk, as the JAX package's kernel does, where the
monolithic search (A5) and the port's f64 oracle hit it.

A6's chunk boxes are c -+ r with r signed (``SearchSpheres.chunk_boxes``),
copied from the TPU kernel's wrapper. A sphere of negative radius (a hollow
sphere's inner surface) gives an inverted box, and when no other sphere of
its chunk covers it no row opens the chunk. The port keeps the reference's
answer, since A6 is held to JAX: the port's A6 (plain version) equals JAX's
``sphere_search_pallas`` in interpret mode, ids bit for bit and t by the
rule of tests/test_torch_sphere_search.py (XLA:CPU contracts multiply-adds
that PyTorch rounds one by one). A5, whose group boxes take |r|, hits the
sphere on every ray, and so does the oracle: a known difference of the
reference. The clustered-against-monolithic sweep test of
tests/test_torch_sphere_clustered.py leaves this scene out by design.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu.core.scene import SceneBuilder as JSceneBuilder
from qt_raytracer_tpu.kernels.sphere_intersect import sphere_search_pallas
from qt_raytracer_tpu_torch.kernels import sphere_intersect as tsi
from qt_raytracer_tpu_torch.testing import oracle, oracle_vec
from qt_raytracer_tpu_torch.utils.convert import scene_from_arrays
from test_torch_sphere_search import _t_tol
from torch_helpers import _one_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's (ROADMAP.md).
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _lone_hollow_sphere():
    """C5's scene: 1,152 slots (18 chunks of 64) unsorted, the ground, small
    spheres in a band near the origin, and in slot 330 (chunk 5) a sphere
    of radius -0.5 far from every other sphere of its chunk. Returns (JAX
    scene, port scene, origins, directions): rays aimed down at it."""
    rng = np.random.default_rng(5)
    b = JSceneBuilder()
    b.lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    for k in range(1, 1152):
        if k == 330:
            b.lambertian((40.0, 3.0, -40.0), -0.5, (0.5, 0.5, 0.5))
        else:
            b.lambertian((rng.uniform(-6, 6), rng.uniform(0.3, 1.0),
                          rng.uniform(-6, 6)), 0.2, (0.5, 0.5, 0.5))
    js = b.build(pad_to=None, spatial_sort=False)
    ts = scene_from_arrays(_arrays(js), device="cpu")
    n = 256
    o = np.stack([rng.uniform(39.8, 40.2, n), np.full(n, 8.0),
                  rng.uniform(-40.2, -39.8, n)], 1).astype(np.float32)
    d = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    return js, ts, o, d


def test_a6_misses_a_lone_hollow_sphere_as_the_reference_does():
    js, ts, o, d = _lone_hollow_sphere()
    assert tsi.prep_sphere_search(ts).num_chunks == 18
    # The chunk box of c -+ r with r = -0.5 is inverted: no row opens it.
    t6, i6 = tsi.sphere_search(ts, torch.from_numpy(o), torch.from_numpy(d),
                               1e-3)
    jt, ji = sphere_search_pallas(js, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                  interpret=True)
    # Ids bitwise; t by the rule of tests/test_torch_sphere_search.py.
    np.testing.assert_array_equal(i6.numpy(), np.asarray(ji))
    jt = np.asarray(jt)
    np.testing.assert_array_equal(t6.numpy() < tsi.BIG, jt < tsi.BIG)
    a, k = _arrays(js), np.asarray(ji)
    err = np.abs(t6.numpy().astype(np.float64) - jt)
    assert (err <= _t_tol(o, d, a["center"][k], a["radius"][k], jt)).all()
    assert (jt < tsi.BIG).all() and not (i6.numpy() == 330).any()
    # The monolithic sweep (A5, group boxes from |r|) hits it on every ray.
    t5, i5 = tsi.sphere_search(ts, torch.from_numpy(o), torch.from_numpy(d),
                               1e-3, min_chunks=10 ** 6)
    assert (i5.numpy() == 330).all()
    # So does the f64 oracle: a known difference of the reference.
    t_or, idx = oracle_vec._hit_scene_vec(oracle.scene_to_np(ts),
                                          o.astype(np.float64),
                                          d.astype(np.float64), 1e-3)
    assert (idx == 330).all()
    err = np.abs(t5.numpy() - t_or)
    k = np.full(len(o), 330)
    assert (err <= _t_tol(o, d, a["center"][k], a["radius"][k], t_or)).all()
