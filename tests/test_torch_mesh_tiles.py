"""The TPU's sub-tiled visit bodies of the clustered mesh search,
``visit="subtile"`` and ``visit="sliced"``, in the port on the CPU: bitwise
equal to ``visit="full"``, and against the JAX package's own bodies with
Pallas in interpret mode, on the rays and mesh of
tests/test_torch_mesh_bodies.py (terrain_world(24, 24), 1,024 rays).

On the TPU the two bodies re-tile the (128 rays, 128 triangles) visit into
(SUBTILE_ROWS, 128) slices with the same expression tree ("sliced" also
skips slices that no lane's gate opened), and the JAX package holds them
bitwise equal to "full". The port runs one ray per thread with a per-lane
gate, which is at least as fine as any slice, so both take the "full"
body. Tolerances against JAX are those of
tests/test_torch_mesh_bodies.py.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_mesh_bodies import (_assert_agree, _jax_search,  # noqa: F401
                                    _search, case, meshes)
from torch_helpers import _one_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's (test_torch_compact.py).
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


@pytest.mark.parametrize("visit", ["subtile", "sliced"])
def test_slice_visits_equal_full_and_match_jax(case, visit):
    got = _search(case, visit=visit)
    for x, y in zip(got, case["full"]):
        np.testing.assert_array_equal(x, y)
    _assert_agree(case, got, _jax_search(case, visit=visit), ["vpu"])
