// Clustered triangle-mesh search for Hopper (sm_90a): kernels A3 and A4.
//
// A3, qtrt_mesh_search, replaces
// qt_raytracer_tpu/kernels/mesh_intersect.py::_mesh_kernel with each of its
// visit bodies, and ::_mesh_kernel_rowgate, with and without the per-lane
// exclude operand: per ray, the closest triangle hit strictly below a
// per-lane cap, with ties going to the lowest BVH-order triangle id; a
// lane's excluded triangle (a BVH-order id, -1 for none; the edge-aware
// background re-trace of diff/edge.py) fails the accept test of every
// visit, as on the TPU (mesh_intersect.py:345-346, :470). The operand and
// the body are template parameters (mesh_search_kernel<EXCL, MODE>), so the
// default instance's code is what it was before either existed:
//   - VPU (mt="vpu", visit "full"; "subtile" and "sliced" too, see below):
//     Moller-Trumbore on the triangle planes (visit_vpu, :360).
//   - ROWGATE (visit="rowgate"; _mesh_kernel_rowgate :233, visit_rowgate
//     :499, prep_row_boxes :163): in a cluster that passes the lane's gate,
//     each 128-triangle row is slab-tested first against its own
//     epsilon-padded box under the lane's running cap at that moment, and
//     skipped when it fails. t_best only shrinks, so a row that fails could
//     never pass later: the same bits as VPU. Row boxes are 6 flat arrays
//     read from global memory (scalar prefetch to SMEM on the TPU), tested
//     by the very slab function that tests the shared cluster tile.
//   - MXU (mt="mxu"; visit_mxu :324, build_mt_features :190): det, u*det,
//     v*det and t*det as bilinear forms of the ray's (d, o x d, o, 1) and
//     19 per-triangle factors (76 bytes a triangle against 36). The
//     candidates round otherwise than VPU's, so it agrees with VPU without
//     being bitwise equal. The TPU runs four [128, q] @ [q, 128] MXU
//     products per triangle row; here it is scalar FP32 without FMA, one
//     thread per ray: a depth of K <= 6 underfills an mma tile (a TF32x3
//     tensor-core form is later speed work), and a simple kernel that is
//     right comes first.
// The TPU's visit_subtile (:484) and visit_sliced (:412) re-tile the visit
// into (SUBTILE_ROWS rays, 128 triangles) slices with the same expression
// tree, sliced also skipping slices that no lane's gate opened; both give
// full's bits. One thread per ray gating each cluster on its own cap is at
// least as fine as any slice, so both run the VPU instance. A4,
// qtrt_mesh_first_cluster, replaces _c1_kernel: per ray, the lowest id of a
// cluster whose slacked, capped slab test passes (k when none), which keys
// the wavefront sort that runs before A3; with a second output (pair=True
// on the TPU, a template flag here) also the lowest crossed id above it,
// for the two-cluster sort key. The plain PyTorch versions are
// mesh_search_plain and first_crossed_cluster_plain in
// qt_raytracer_tpu_torch/kernels/mesh_intersect.py.
//
// Layout (prep_mesh_clusters): triangles are BVH-ordered and packed into k
// clusters of g consecutive triangles (g = cluster_rows * 128, 512 by
// default, for multi-cluster meshes), padded with degenerate triangles;
// tris is [9, p_stride] f32 (v0, e1, e2, one component per row), or for
// MXU [19, p_stride] f32 (the factors, one per row); boxes is [6, k_stride]
// f32 (lo xyz, hi xyz), the epsilon-padded cluster AABBs; rows (ROWGATE) is
// [6, r_stride] f32, the epsilon-padded AABB of each 128-triangle row.
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
// and staging are untuned. The row gate and a smaller cluster size
// (prep_mesh_clusters(cluster_rows=)) both shorten the visit list that
// sets the time; chip_smoke.py times them beside VPU.
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

// A3's bodies (the header comment).
enum SearchMode : int { VPU = 0, ROWGATE = 1, MXU = 2 };

// Moller-Trumbore over triangles [lo, hi) of the planes tris: the strict
// '<' update of the lane's running hit, in ascending id order.
template <bool EXCL>
__device__ __forceinline__ void sweep_vpu(const float* __restrict__ tris,
                                          size_t p_stride, int lo, int hi,
                                          const Ray& r, const float d[3],
                                          float t_min, int ex, float& t_best,
                                          int& best) {
  for (int p = lo; p < hi; ++p) {
    float v0[3], e1[3], e2[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v0[a] = __ldg(tris + a * p_stride + p);
      e1[a] = __ldg(tris + (3 + a) * p_stride + p);
      e2[a] = __ldg(tris + (6 + a) * p_stride + p);
    }
    float t;
    bool ok = moller_trumbore(r.o, d, v0, e1, e2, t_min, t_best, t);
    if constexpr (EXCL) ok = ok && p != ex;
    if (ok) {
      t_best = t;
      best = p;
    }
  }
}

// The same with the bilinear form over the factor planes f.
template <bool EXCL>
__device__ __forceinline__ void sweep_mxu(const float* __restrict__ f,
                                          size_t p_stride, int lo, int hi,
                                          const Ray& r, const float d[3],
                                          const float m[3], float t_min,
                                          int ex, float& t_best, int& best) {
  for (int p = lo; p < hi; ++p) {
    float fp[MT_FEATURES];
#pragma unroll
    for (int a = 0; a < MT_FEATURES; ++a) fp[a] = __ldg(f + a * p_stride + p);
    float t;
    bool ok = moller_trumbore_bilinear(r.o, d, m, fp, t_min, t_best, t);
    if constexpr (EXCL) ok = ok && p != ex;
    if (ok) {
      t_best = t;
      best = p;
    }
  }
}

template <bool EXCL, int MODE>
__global__ void __launch_bounds__(BLOCK) mesh_search_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const float* __restrict__ t_cap,
    const int* __restrict__ excl, const float* __restrict__ tris, int p_stride,
    const float* __restrict__ rows, int r_stride,
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
  float m[3] = {0.f, 0.f, 0.f};  // o x d, read only by MXU
  if constexpr (MODE == MXU) ray_moment(r.o, d, m);
  float t_best = cap0;
  int best = 0;
  const size_t ps = static_cast<size_t>(p_stride);
  const size_t rs = static_cast<size_t>(r_stride);

  if (block_live) {
    for (int base = 0; base < k; base += TILE_K) {
      const int m_tile = min(TILE_K, k - base);
      __syncthreads();
      stage_boxes(tile, boxes, k_stride, base, m_tile);
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < m_tile; ++j) {
        float enter;
        if (!slab(tile, j, r, t_min, enter) || !(enter <= gate_cap(t_best)))
          continue;
        const int lo = (base + j) * g;
        if constexpr (MODE == ROWGATE) {
          for (int row = lo / ROW; row < (lo + g) / ROW; ++row) {
            float row_enter;
            if (!slab_box(__ldg(rows + row), __ldg(rows + rs + row),
                          __ldg(rows + 2 * rs + row),
                          __ldg(rows + 3 * rs + row),
                          __ldg(rows + 4 * rs + row),
                          __ldg(rows + 5 * rs + row), r, t_min, row_enter) ||
                !(row_enter <= gate_cap(t_best)))
              continue;
            sweep_vpu<EXCL>(tris, ps, row * ROW, (row + 1) * ROW, r, d, t_min,
                            ex, t_best, best);
          }
        } else if constexpr (MODE == MXU) {
          sweep_mxu<EXCL>(tris, ps, lo, lo + g, r, d, m, t_min, ex, t_best,
                          best);
        } else {
          sweep_vpu<EXCL>(tris, ps, lo, lo + g, r, d, t_min, ex, t_best,
                          best);
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

// Launch instance MODE of A3, with the exclude operand when excl is set.
template <int MODE>
void launch_search(int grid, cudaStream_t st, const float* ox,
                   const float* oy, const float* oz, const float* dx,
                   const float* dy, const float* dz, const bool* alive,
                   const float* t_cap, const int* excl, const float* tris,
                   int p_stride, const float* rows, int r_stride,
                   const float* boxes, int k, int k_stride, int g,
                   float t_min, int n, float* t_out, int* idx_out) {
  if (excl != nullptr) {
    mesh_search_kernel<true, MODE><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, excl, tris, p_stride, rows,
        r_stride, boxes, k, k_stride, g, t_min, n, t_out, idx_out);
  } else {
    mesh_search_kernel<false, MODE><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, nullptr, tris, p_stride, rows,
        r_stride, boxes, k, k_stride, g, t_min, n, t_out, idx_out);
  }
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
// [9, p_stride] f32 triangle planes (mode VPU, ROWGATE) or [19, p_stride]
// f32 factor planes (MXU), with p_stride >= k * g; rows: [6, r_stride] f32
// row boxes with r_stride >= k * g / 128 (ROWGATE), else unread (null);
// boxes: [6, k_stride] f32; g: triangles per cluster, a multiple of 128;
// mode: 0 VPU, 1 ROWGATE, 2 MXU. t_out: [n] f32 (BIG where no triangle beat
// the cap, and on dead lanes); idx_out: [n] i32 (the winner's BVH-order
// id, else 0). Launches on `stream`; returns the cudaError_t of the launch
// (0 = success).
extern "C" int qtrt_mesh_search(const float* ox, const float* oy,
                                const float* oz, const float* dx,
                                const float* dy, const float* dz,
                                const bool* alive, const float* t_cap,
                                const int* excl, const float* tris,
                                int p_stride, const float* rows, int r_stride,
                                const float* boxes, int k, int k_stride,
                                int g, int mode, float t_min, int n,
                                float* t_out, int* idx_out, void* stream) {
  if (n <= 0 || k <= 0 || g <= 0 || k_stride < k ||
      static_cast<long long>(k) * g > p_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == ROWGATE &&
      (rows == nullptr || g % ROW != 0 ||
       static_cast<long long>(k) * (g / ROW) > r_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n / BLOCK + (n % BLOCK != 0);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case VPU:
      launch_search<VPU>(grid, st, ox, oy, oz, dx, dy, dz, alive, t_cap, excl,
                         tris, p_stride, nullptr, 0, boxes, k, k_stride, g,
                         t_min, n, t_out, idx_out);
      break;
    case ROWGATE:
      launch_search<ROWGATE>(grid, st, ox, oy, oz, dx, dy, dz, alive, t_cap,
                             excl, tris, p_stride, rows, r_stride, boxes, k,
                             k_stride, g, t_min, n, t_out, idx_out);
      break;
    case MXU:
      launch_search<MXU>(grid, st, ox, oy, oz, dx, dy, dz, alive, t_cap, excl,
                         tris, p_stride, nullptr, 0, boxes, k, k_stride, g,
                         t_min, n, t_out, idx_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
