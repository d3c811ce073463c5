// Clustered triangle-mesh search for Hopper (sm_90a): kernels A3 and A4.
//
// A3, qtrt_mesh_search, replaces
// qt_raytracer_tpu/kernels/mesh_intersect.py::_mesh_kernel in its default
// configuration (mt="vpu", visit="full"), with and without the per-lane
// exclude operand: per ray, the closest triangle hit strictly below a
// per-lane cap, with ties going to the lowest BVH-order triangle id; a
// lane's excluded triangle (a BVH-order id, -1 for none; the edge-aware
// background re-trace of diff/edge.py) fails the accept test of every
// visit, as on the TPU (mesh_intersect.py:345-346). The operand is a
// template flag, so without it the compiled kernel is unchanged. A4,
// qtrt_mesh_first_cluster, replaces _c1_kernel: per ray, the lowest id of a
// cluster whose slacked, capped slab test passes (k when none), which keys
// the wavefront sort that runs before A3; with a second output (pair=True
// on the TPU, a template flag here) also the lowest crossed id above it,
// for the two-cluster sort key. The plain PyTorch versions are
// mesh_search_plain and first_crossed_cluster_plain in
// qt_raytracer_tpu_torch/kernels/mesh_intersect.py.
//
// Layout (prep_mesh_clusters): triangles are BVH-ordered and packed into k
// clusters of g consecutive triangles (g = 512 for multi-cluster meshes),
// padded with degenerate triangles; tris is [9, p_stride] f32 (v0, e1, e2,
// one component per row); boxes is [6, k_stride] f32 (lo xyz, hi xyz), the
// epsilon-padded cluster AABBs.
//
// What bounds it on the H100. Moller-Trumbore is some 40 single-rounded
// FP32 operations and 9 loads per ray-triangle pair. A ray visits the
// clusters whose box its ray segment enters before its running hit; a warp
// runs the union of its 32 lanes' visits, 512 triangles each. On the 1080p
// terrain (99,458 triangles, 195 clusters) that is estimated at some 10
// clusters, 5,000 pairs and 2e5 instructions per ray, so instruction issue
// should bound it, as it bounds A1 (the visits are not counted). The 3.6 MB
// of triangle planes stay in the 50 MB L2, and the lanes of a warp that
// visit a cluster read the same triangle at once (one broadcast transaction
// per load), so memory should not bound it. Measured on an H100 80GB HBM3
// at 700 W: 8.0 ms for the 414,720 primary rays of the terrain frame's
// middle chunk, 13.5 ms for its sorted bounce-2 wavefront (23.9 ms
// unsorted), some 83% of that frame's device time. The pair search's
// fallback later showed what sets that time: with all but the 0.4% of the
// bounce wavefront's live rays that cross more than 24 clusters masked out,
// the sorted sweep takes as long as on the whole wavefront (chip_smoke.py's
// pair-search phase). So the time is that of the longest visit list of one
// warp (the union of its 32 lanes' lists; a grazing ray alone crosses up to
// 41 of the 195 clusters, 512 triangles each, one after the other), not of
// the sum of the work.
//
// What the design does about it. One thread per ray keeps its running
// (t_best, idx) in registers. Each block stages the cluster boxes in shared
// memory (TILE_K boxes at a time, so any k fits) and each lane gates every
// cluster on its own running cap: it skips a cluster whose slab entry lies
// beyond t_best * 1.0001 + 1e-4 (clamped below 1e37), the TPU kernel's
// gate (mesh_intersect.py:568-602) taken per lane instead of per 128-ray
// group with a cap that lags one 32-cluster block. The slack and the
// epsilon-padded boxes keep the gate conservative: a triangle that the ray
// hits lies inside its cluster's box by the padding on every axis, so the
// gate never drops a winner, and the result is the ungated sweep's. The
// cost that remains is the union of the lanes' visits in a warp: the
// crossing-key sort before A3 (its key from A4) groups rays by their first
// crossed cluster so that neighbouring lanes visit the same clusters. No
// tensor-core form applies: the accept test needs compares and a divide per
// pair. Triangles are not staged in shared memory yet; tiling, occupancy
// and staging are untuned.
//
// Numerics: mesh_common.cuh (every op rounded on its own, the TPU kernel's
// expression tree). In ascending triangle order, the strict '<' update of
// the running minimum is the TPU's per-row min-then-match followed by its
// strict 'better'. A dead lane gets t = BIG and idx = 0 (the TPU leaves dead
// lanes unspecified; every caller masks them).

#include <cuda_runtime.h>

#include "mesh_common.cuh"

namespace {

using namespace qtrt_mesh;

template <bool PAIR>
__global__ void __launch_bounds__(BLOCK) first_cluster_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const float* __restrict__ t_cap,
    const float* __restrict__ boxes, int k, int k_stride, float t_min, int n,
    int* __restrict__ out, int* __restrict__ out2) {
  __shared__ float tile[6][TILE_K];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < n && alive[i];
  const bool block_live = __syncthreads_or(live);

  Ray r = {};
  float d[3] = {0.f, 0.f, 1.f};
  float cap = 0.f;
  if (live) {
    r = load_ray(i, ox, oy, oz, dx, dy, dz, d);
    cap = gate_cap(t_cap[i]);
  }
  int c1 = k;
  int c2 = k;  // the next crossed id above c1; sought only when PAIR
  if (block_live) {
    for (int base = 0; base < k; base += TILE_K) {
      const int m = min(TILE_K, k - base);
      __syncthreads();
      stage_boxes(tile, boxes, k_stride, base, m);
      __syncthreads();
      if (!live || (PAIR ? c2 : c1) < k) continue;
      for (int j = 0; j < m; ++j) {
        float enter;
        if (slab(tile, j, r, t_min, enter) && enter <= cap) {
          if (PAIR && c1 == k) {
            c1 = base + j;
            continue;
          }
          if (PAIR) c2 = base + j; else c1 = base + j;
          break;
        }
      }
    }
  }
  if (i >= n) return;
  out[i] = c1;
  if constexpr (PAIR) out2[i] = c2;
}

template <bool EXCL>
__global__ void __launch_bounds__(BLOCK) mesh_search_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const float* __restrict__ t_cap,
    const int* __restrict__ excl, const float* __restrict__ tris, int p_stride,
    const float* __restrict__ boxes, int k, int k_stride, int g, float t_min,
    int n, float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float tile[6][TILE_K];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < n && alive[i];
  const bool block_live = __syncthreads_or(live);

  Ray r = {};
  float d[3] = {0.f, 0.f, 1.f};
  float cap0 = BIG;
  int ex = -1;  // the lane's excluded triangle id; read only when EXCL
  if (live) {
    r = load_ray(i, ox, oy, oz, dx, dy, dz, d);
    cap0 = t_cap[i];
    if constexpr (EXCL) ex = excl[i];
  }
  float t_best = cap0;
  int best = 0;

  const float* v0x = tris;
  const float* v0y = tris + static_cast<size_t>(p_stride);
  const float* v0z = tris + 2 * static_cast<size_t>(p_stride);
  const float* e1x = tris + 3 * static_cast<size_t>(p_stride);
  const float* e1y = tris + 4 * static_cast<size_t>(p_stride);
  const float* e1z = tris + 5 * static_cast<size_t>(p_stride);
  const float* e2x = tris + 6 * static_cast<size_t>(p_stride);
  const float* e2y = tris + 7 * static_cast<size_t>(p_stride);
  const float* e2z = tris + 8 * static_cast<size_t>(p_stride);

  if (block_live) {
    for (int base = 0; base < k; base += TILE_K) {
      const int m = min(TILE_K, k - base);
      __syncthreads();
      stage_boxes(tile, boxes, k_stride, base, m);
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < m; ++j) {
        float enter;
        if (!slab(tile, j, r, t_min, enter) || !(enter <= gate_cap(t_best)))
          continue;
        const int lo = (base + j) * g;
        for (int p = lo; p < lo + g; ++p) {
          const float v0[3] = {__ldg(v0x + p), __ldg(v0y + p), __ldg(v0z + p)};
          const float e1[3] = {__ldg(e1x + p), __ldg(e1y + p), __ldg(e1z + p)};
          const float e2[3] = {__ldg(e2x + p), __ldg(e2y + p), __ldg(e2z + p)};
          float t;
          bool ok = moller_trumbore(r.o, d, v0, e1, e2, t_min, t_best, t);
          if constexpr (EXCL) ok = ok && p != ex;
          if (ok) {
            t_best = t;
            best = p;
          }
        }
      }
    }
  }
  if (i >= n) return;
  // A mesh hit counts only when some triangle beat the lane's cap.
  const bool won = live && t_best < cap0;
  t_out[i] = won ? t_best : BIG;
  idx_out[i] = won ? best : 0;
}

}  // namespace

// Kernel A4. Ray operands: [n] f32 components, [n] bool alive, [n] f32
// t_cap (BIG for no cap); boxes: [6, k_stride] f32; out: [n] i32, the first
// passing cluster id or k (dead lanes: k); out2: null, or [n] i32 for the
// next passing id above it (k when none). Launches on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int qtrt_mesh_first_cluster(const float* ox, const float* oy,
                                       const float* oz, const float* dx,
                                       const float* dy, const float* dz,
                                       const bool* alive, const float* t_cap,
                                       const float* boxes, int k,
                                       int k_stride, float t_min, int n,
                                       int* out, int* out2, void* stream) {
  if (n <= 0 || k <= 0 || k_stride < k)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n / BLOCK + (n % BLOCK != 0);
  const auto st = static_cast<cudaStream_t>(stream);
  if (out2 != nullptr) {
    first_cluster_kernel<true><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, boxes, k, k_stride, t_min, n,
        out, out2);
  } else {
    first_cluster_kernel<false><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, boxes, k, k_stride, t_min, n,
        out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel A3. Ray operands as for A4; excl: [n] i32 excluded BVH-order
// triangle id per lane (-1: none), or null for no exclude operand; tris:
// [9, p_stride] f32 with p_stride >= k * g; boxes: [6, k_stride] f32; g: triangles per cluster.
// t_out: [n] f32 (BIG where no triangle beat the cap, and on dead lanes);
// idx_out: [n] i32 (the winner's BVH-order id, else 0). Launches on
// `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int qtrt_mesh_search(const float* ox, const float* oy,
                                const float* oz, const float* dx,
                                const float* dy, const float* dz,
                                const bool* alive, const float* t_cap,
                                const int* excl, const float* tris,
                                int p_stride,
                                const float* boxes, int k, int k_stride,
                                int g, float t_min, int n, float* t_out,
                                int* idx_out, void* stream) {
  if (n <= 0 || k <= 0 || g <= 0 || k_stride < k ||
      static_cast<long long>(k) * g > p_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n / BLOCK + (n % BLOCK != 0);
  const auto st = static_cast<cudaStream_t>(stream);
  if (excl != nullptr) {
    mesh_search_kernel<true><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, excl, tris, p_stride, boxes, k,
        k_stride, g, t_min, n, t_out, idx_out);
  } else {
    mesh_search_kernel<false><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, nullptr, tris, p_stride, boxes,
        k, k_stride, g, t_min, n, t_out, idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}
