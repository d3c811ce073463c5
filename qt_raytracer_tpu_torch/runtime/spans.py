"""Named spans of the port's layers, for a ``torch.profiler`` capture.

``annotate(name)`` opens a ``torch.profiler.record_function`` span while a
profiler records, and returns one shared no-op context otherwise: the
check costs a fraction of a microsecond, a ``record_function`` several,
and a 1080p frame opens a few hundred spans. A running profiler is the
only switch. In the Chrome trace the spans are ``user_annotation`` events
on the thread that opened them, over the card's kernels in Perfetto
(``app.profiling.trace``). The benchmark's per-layer metrics put each
kernel under the innermost span around its launch.

| span | opened around |
|---|---|
| ``qtrt.render.chunk`` | one (pixel chunk, sample batch) of ``render.accumulate_pixels``, inside the function ``torch.utils.checkpoint`` wraps, so the backward's recompute opens it again |
| ``qtrt.prep`` | one build of the kernel tables (``integrator_flat.build_tables``: ``prep_fused_spheres``, ``prep_world``): once a forward render call, before its chunks (``render.shared_tables``), or once a trace call under autograd and on the routes that build their own |
| ``qtrt.rng`` | ``sampling.pixel_states``, ``sample_keys``, ``stream_uniforms`` |
| ``qtrt.shade`` | ``integrator_flat._shade``: scatter, emission, NEE, roulette (without NEE on the card: the one launch of ``shade_kernel``, its uniforms included) |
| ``qtrt.hit.mesh`` | ``world.search_mesh`` and ``accel.traverse.intersect_mesh`` |
| ``qtrt.train.backward`` | ``torch.autograd.grad`` of ``diff.inverse.value_and_grad`` |

``counts`` is the port's one registry of counts, always on: every launch of
a hand-written kernel adds 1 under the names its wrapper hands
``cuda_build.launch`` (``"fused_hit"``, ``"mesh_search[exclude]"``, ...),
and ``integrator_flat.build_tables`` under ``"table_builds"``. A run clears
it and reads it back to show which kernels its path went through.
"""

from __future__ import annotations

import collections
import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

CHUNK = "qtrt.render.chunk"
PREP = "qtrt.prep"
RNG = "qtrt.rng"
SHADE = "qtrt.shade"
HIT_MESH = "qtrt.hit.mesh"
TRAIN_BACKWARD = "qtrt.train.backward"
SPANS = (CHUNK, PREP, RNG, SHADE, HIT_MESH, TRAIN_BACKWARD)

_OFF = contextlib.nullcontext()

counts: collections.Counter = collections.Counter()


def annotate(name: str):
    """A span named name while a profiler records; the shared no-op context
    otherwise."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function runs inside annotate(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
