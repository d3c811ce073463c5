"""What the port's test modules share; imports no JAX, so the card tests
(``tests/test_torch_cuda.py``) take it too.

- ``_one_thread``: PyTorch at one thread for the module that imports it by
  name (an autouse fixture). The port's CPU tests run small tensors: more
  threads gain nothing alone, and beside other test workers they only
  contend for the cores.
- ``with_copies``: a mesh's kernel tables with triangles copied over
  others, for ties made on purpose.
"""

import pytest
import torch

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
    for src, dst in pairs:
        tp[:, dst] = tp[:, src]
    v0, e1, e2 = (tp[3 * a:3 * a + 3].T for a in range(3))
    eps = mi._box_eps(mesh)
    k, g = mc.k, mc.tris_per_cluster
    lo, hi = mi._padded_boxes(v0, e1, e2, k, eps)
    boxes = mc.box_planes.clone()
    boxes[:3, :k], boxes[3:, :k] = lo.T, hi.T
    lo_r, hi_r = mi._padded_boxes(v0, e1, e2, k * g // mi.LANE, eps)
    rows = torch.cat([lo_r.T, hi_r.T]).contiguous()
    return mi.with_cluster_boxes(
        mc._replace(tri_planes=tp.contiguous(), row_boxes=rows),
        boxes.contiguous())
