"""Profiling / observability hooks (counterpart of
``qt_raytracer_tpu.app.profiling``).

The reference's only instrumentation is QElapsedTimer + atomic counters
formatted into statsText (SURVEY.md §5). Here:

  - trace(): a ``torch.profiler`` capture of host and card activity,
    written as a Chrome trace (view it in Perfetto or chrome://tracing).
  - annotate(): a named span inside the capture
    (``torch.profiler.record_function``), and the shared no-op context
    when no profiler records (``runtime.spans``, which the port's own
    layers call).
  - device_memory_stats(): live memory statistics of each CUDA card.

An operator's look at where a frame's time goes::

    with profiling.trace("traces"):
        render_linear(scene, cam, cfg, 0)

Perfetto then shows the port's ``qtrt.`` spans (``runtime.spans.SPANS``:
pixel chunk, table prep, RNG, shading, mesh search, the train step's
backward) on the host rows, above the card's kernels they launched. The
spans cost nothing measurable when no profiler runs.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator

import torch

from ..runtime.spans import annotate  # noqa: F401  (one implementation)


@contextlib.contextmanager
def trace(logdir: str | None = None) -> Iterator[torch.profiler.profile]:
    """Capture a trace of everything inside the context (host ops, and the
    card's kernels when CUDA is there) and write it into ``logdir`` as
    ``trace_<ns>.json``; None is ``qtrt_torch_trace`` under the temporary
    directory. Yields the profiler; its ``trace_path`` attribute names the
    file, which is written when the context exits, also by an exception."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "qtrt_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    try:
        with prof:
            try:
                yield prof
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()  # the card's work in the capture
    finally:
        prof.export_chrome_trace(prof.trace_path)


def device_memory_stats() -> list[dict]:
    """One dict per CUDA card: its name and ``torch.cuda.memory_stats``
    (bytes allocated, reserved, peaks, ...). Empty without CUDA."""
    if not torch.cuda.is_available():
        return []
    return [{"device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
             **torch.cuda.memory_stats(i)}
            for i in range(torch.cuda.device_count())]
