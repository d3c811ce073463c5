"""The edge-aware config-5 view-step of the port under
``intersector="xla"`` on the CPU against the JAX package's, as
tests/test_torch_xla_step.py holds the pathwise one (its tolerances): the
background re-trace runs the BVH walk with its exclude operand, and the
shadow block its shadow rays; the edge-aware image equals the pathwise one
bit for bit. A module of its own for the tier-1 time budget.
"""

import jax
import pytest
import torch

from test_torch_xla_step import view_step_case
from torch_helpers import _one_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's (ROADMAP.md).
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


def test_edge_aware_view_step_matches_jax():
    view_step_case(edge_aware=True)
