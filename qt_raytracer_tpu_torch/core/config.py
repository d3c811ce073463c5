"""Render configuration.

The same frozen dataclass as ``qt_raytracer_tpu.core.config``: the same
fields, defaults and clamps, so one configuration describes the same frame in
both packages. The config accepts every value the JAX package accepts, and
the renderer runs each of them.

Twelve fields are the port's own. The JAX package reads them from the
environment while it traces; here they are explicit, validated options with
the same meaning: ``edge_kernel_px``, ``edge_kernel_order`` and
``edge_shadow`` (``QTRT_EDGE_KERNEL_PX``, ``QTRT_EDGE_KERNEL_ORDER``,
``QTRT_EDGE_SHADOW``, ``diff/edge.py``), and the mesh-search options
``mesh_kernel`` (``QTRT_MESH_KERNEL``), ``mesh_pair_c`` (``QTRT_PAIR_C``),
``mesh_compact`` (``QTRT_MESH_COMPACT``), ``mesh_sort0``
(``QTRT_MESH_SORT0``), ``mesh_sort_mode`` (``QTRT_MESH_SORT``),
``mesh_visit`` (``QTRT_MESH_VISIT``), ``mesh_mt`` (``QTRT_MESH_MT``),
``mesh_sort_pipe`` (``QTRT_MESH_SORT_PIPE``) and ``mesh_cluster_rows``
(``QTRT_CLUSTER_ROWS``). The defaults are the JAX package's, but for
``mesh_sort_pipe``: "gather" here, where the JAX package defaults to
"fused". The port's search has one sort step, which both values name, so
that field is validated and read by no search. Where the JAX package falls
back to its default on an unknown value, the port raises.
"""

from __future__ import annotations

import dataclasses

from ..kernels.mesh_intersect import (CLUSTER_ROWS, MT_MODES, SORT_MODES,
                                      SORT_PIPES, VISIT_MODES)

# Validation ranges mirrored from the reference UI
# (resources/qml/Main.qml:394,426,458,491 and RayTracerFboItem.cpp:189-228).
MIN_DIM = 1
MAX_WIDTH = 3840
MAX_HEIGHT = 2160
MIN_SPP = 1
MAX_SPP = 1000
MIN_DEPTH = 1
MAX_DEPTH = 100

# AA presets (resources/qml/Main.qml:91-102).
AA_PRESETS = {"low": 8, "medium": 24, "high": 64}

# Intersector values of the JAX package. Each runs the CUDA kernels on CUDA
# tensors and their plain PyTorch versions on CPU tensors; the "*_interpret"
# values run the plain versions on any device (the counterpart of Pallas
# interpret mode). "fused" is the forward-only flat path; "fused_diff" the
# gradient-capable flat path on sphere scenes (mesh worlds take "pallas"
# under it); "pallas" the [N,3] gradient integrator; "xla" the same
# integrator on the portable search: the [N,S] sphere search in PyTorch ops
# and the BVH walk. "auto" is "fused": on the card, auto means the kernels.
# The JAX package maps "auto" to "xla" off a TPU; the port deliberately does
# not carry that mapping over.
INTERSECTORS = ("auto", "fused", "fused_interpret", "fused_diff",
                "fused_diff_interpret", "pallas", "pallas_interpret", "xla")
MESH_KERNELS = ("clustered", "pairs", "hybrid")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable).

    Defaults match the reference QML panel (resources/qml/Main.qml:10-13):
    400x225, 24 spp, max depth 10. See the JAX package's RenderConfig for
    the meaning of every field.
    """

    width: int = 400
    height: int = 225
    spp: int = 24
    max_depth: int = 10
    t_min: float = 1.0e-3
    quantizer: str = "cpu"
    samples_per_batch: int = 1
    rr_start: int = 0
    rng: str = "threefry"
    nee: bool = False
    intersector: str = "auto"
    pixel_chunk: int = 0
    # Edge-aware (silhouette and first-vertex shadow-edge) gradients,
    # ``diff.edge``: a primal-zero boundary term on gradient renders, one
    # sample per batch.
    edge_aware: bool = False
    edge_kernel_px: float = 1.0   # one-sided kernel width W, in pixels
    edge_kernel_order: int = 1    # 1: triangular weight; 2: 2 w_{W/2} - w_W
    edge_shadow: bool = True      # the NEE shadow-edge term (needs nee)
    # The mesh search of a mesh world; no choice changes a bit of the image.
    # "clustered": A3 behind the A4 sort; "pairs": the pair-wavefront search
    # (A7, A8) at every bounce; "hybrid": clustered at bounce 0, pairs after
    # (on the flat path; the [N,3] integrator takes clustered under it).
    mesh_kernel: str = "clustered"
    mesh_pair_c: int = 6          # crossing-list width of the pair search
    mesh_compact: bool = False    # flat world path: sort live rays first
    mesh_sort0: bool = True       # False: no wavefront sort at bounce 0
    mesh_sort_mode: str = "crossing"   # the clustered search's sort key
    # The clustered search's kernel body and cluster size (A3's instances,
    # kernels/mesh_intersect.py): "rowgate" gates each 128-triangle row on
    # its own box, "mxu" takes the bilinear-form Moller-Trumbore (the one
    # option that may change a bit: its candidates round otherwise).
    mesh_visit: str = "full"      # "full", "subtile", "sliced", "rowgate"
    mesh_mt: str = "vpu"          # "vpu", "mxu"
    mesh_sort_pipe: str = "gather"   # "gather", "fused": one step here
    mesh_cluster_rows: int = CLUSTER_ROWS   # 128-triangle rows per cluster

    def __post_init__(self):
        object.__setattr__(self, "width", _clamp(self.width, MIN_DIM, MAX_WIDTH))
        object.__setattr__(self, "height", _clamp(self.height, MIN_DIM, MAX_HEIGHT))
        object.__setattr__(self, "spp", _clamp(self.spp, MIN_SPP, MAX_SPP))
        object.__setattr__(self, "max_depth", _clamp(self.max_depth, MIN_DEPTH, MAX_DEPTH))
        if self.quantizer not in ("cpu", "gpu"):
            raise ValueError(f"quantizer must be 'cpu' or 'gpu', got {self.quantizer!r}")
        if self.intersector not in INTERSECTORS:
            raise ValueError(f"unknown intersector {self.intersector!r}")
        if self.rng not in ("threefry", "hash"):
            raise ValueError(f"unknown rng {self.rng!r}")
        if self.pixel_chunk < -1:
            raise ValueError(f"pixel_chunk must be >= -1, got {self.pixel_chunk}")
        if not float(self.edge_kernel_px) > 0.0:
            raise ValueError(f"edge_kernel_px must be > 0, got "
                             f"{self.edge_kernel_px}")
        if self.edge_kernel_order not in (1, 2):
            raise ValueError(f"edge_kernel_order must be 1 or 2, got "
                             f"{self.edge_kernel_order}")
        if self.mesh_kernel not in MESH_KERNELS:
            raise ValueError(f"mesh_kernel must be one of {MESH_KERNELS}, "
                             f"got {self.mesh_kernel!r}")
        if isinstance(self.mesh_pair_c, bool) or \
                not isinstance(self.mesh_pair_c, int) or self.mesh_pair_c < 1:
            raise ValueError(f"mesh_pair_c must be an integer >= 1, got "
                             f"{self.mesh_pair_c!r}")
        for name in ("mesh_compact", "mesh_sort0"):
            if not isinstance(getattr(self, name), bool):
                raise ValueError(f"{name} must be a bool, got "
                                 f"{getattr(self, name)!r}")
        for name, allowed in (("mesh_sort_mode", SORT_MODES),
                              ("mesh_visit", VISIT_MODES),
                              ("mesh_mt", MT_MODES),
                              ("mesh_sort_pipe", SORT_PIPES)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{getattr(self, name)!r}")
        if isinstance(self.mesh_cluster_rows, bool) or not isinstance(
                self.mesh_cluster_rows, int) or self.mesh_cluster_rows < 1:
            raise ValueError(f"mesh_cluster_rows must be a positive int, got "
                             f"{self.mesh_cluster_rows!r}")
        if self.edge_aware and self.samples_per_batch != 1:
            # The boundary term needs per-sample pixel coordinates, so an
            # edge-aware render traces one sample per batch (clamped, as
            # every panel input is).
            object.__setattr__(self, "samples_per_batch", 1)
        if self.spp % self.samples_per_batch != 0:
            spb = self.samples_per_batch
            while self.spp % spb != 0:
                spb -= 1
            object.__setattr__(self, "samples_per_batch", spb)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height


def mesh_search_options(cfg: RenderConfig) -> dict:
    """cfg's mesh-search options as the keyword arguments of
    ``integrator.trace``, ``integrator_flat.trace_flat_world`` and
    ``world.intersect_world``."""
    return dict(mesh_kernel=cfg.mesh_kernel, mesh_pair_c=cfg.mesh_pair_c,
                mesh_sort_mode=cfg.mesh_sort_mode, mesh_visit=cfg.mesh_visit,
                mesh_mt=cfg.mesh_mt, mesh_cluster_rows=cfg.mesh_cluster_rows)


def _clamp(x: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(x)))
