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
// the body are template parameters (mesh_search_kernel<EXCL, MODE>); all
// three bodies run on the one warp-per-ray search described below:
//   - VPU (mt="vpu", visit "full"; "subtile" and "sliced" too, see below):
//     Moller-Trumbore on the triangle planes (visit_vpu, :360).
//   - ROWGATE (visit="rowgate"; _mesh_kernel_rowgate :233, visit_rowgate
//     :499, prep_row_boxes :163): in a cluster that passes the lane's gate,
//     each 128-triangle row is slab-tested first against its own
//     epsilon-padded box under the lane's running cap at that moment, and
//     skipped when it fails. t_best only shrinks, so a row that fails could
//     never pass later: the same bits as VPU. Row boxes are 6 flat arrays
//     read from global memory (scalar prefetch to SMEM on the TPU), tested
//     by the very slab function that tests the cluster boxes.
//   - MXU (mt="mxu"; visit_mxu :324, build_mt_features :190): det, u*det,
//     v*det and t*det as bilinear forms of the ray's (d, o x d, o, 1) and
//     19 per-triangle factors (76 bytes a triangle against 36). The
//     candidates round otherwise than VPU's, so it agrees with VPU without
//     being bitwise equal. The TPU runs four [128, q] @ [q, 128] MXU
//     products per triangle row; here it is scalar FP32 without FMA: a depth
//     of K <= 6 underfills an mma tile (a TF32x3 tensor-core form is later
//     speed work).
// The TPU's visit_subtile (:484) and visit_sliced (:412) re-tile the visit
// into (SUBTILE_ROWS rays, 128 triangles) slices with the same expression
// tree, sliced also skipping slices that no lane's gate opened; both give
// full's bits. A warp gating each cluster on its one ray's own cap is at
// least as fine as any slice, so both run the VPU instance. The plain
// PyTorch version is mesh_search_plain in
// qt_raytracer_tpu_torch/kernels/mesh_intersect.py. A4 is described at the
// end of this comment.
//
// Layout (prep_mesh_clusters): triangles are BVH-ordered and packed into k
// clusters of g consecutive triangles (g = cluster_rows * 128, 512 by
// default, for multi-cluster meshes), padded with degenerate triangles;
// tris is [9, p_stride] f32 (v0, e1, e2, one component per row), or for
// MXU [19, p_stride] f32 (the factors, one per row); boxes is [6, k_stride]
// f32 (lo xyz, hi xyz), the epsilon-padded cluster AABBs; rows (ROWGATE) is
// [6, r_stride] f32, the epsilon-padded AABB of each 128-triangle row.
//
// What bounds it on the H100. Moller-Trumbore is some 45 single-rounded
// FP32 operations (a divide among them) and 9 loads per ray-triangle pair.
// A ray visits the clusters whose box its segment enters before its
// running hit: on the 1080p terrain (99,458 triangles, 195 clusters of
// 512) some 7 a primary ray, and a grazing ray up to 41. The parent kernel
// ran one thread per ray, so a warp ran the union of its 32 lanes' visits,
// 512 triangles each, one after the other: a warp with one grazing lane
// paid for 41 clusters while the other lanes idled (PERF.md §6: masking
// out all but the 0.4% of bounce rays that cross more than 24 clusters
// left the sorted sweep's time as it was). With that gone, what remains is
// the pairs themselves: instructions, and the bytes of the triangles each pair
// reads (36 a triangle, from L2 when L1 misses).
//
// What the design does about it. One warp per ray, the parallelism inside
// a visited cluster moved from rays to the (ray, triangle) pairs:
//   - The cluster gate. Lane j slab-tests cluster base + j, 32 clusters at
//     a time, under the ray's cap at the start of those 32 (a ballot); the
//     warp then visits the passing ones in ascending order, each tested
//     again under the cap of its turn, so the warp visits exactly the
//     clusters the parent's per-lane gate visited: the slab entry at most
//     t_best * 1.0001 + 1e-4 (clamped below 1e37), the TPU kernel's gate
//     (mesh_intersect.py:568-602) taken per ray. The slack and the
//     epsilon-padded boxes keep it conservative: a triangle the ray hits
//     lies inside its cluster's box by the padding on every axis, so the
//     gate never drops a winner.
//   - The visit. Lane l tests triangles lo + l, lo + l + 32, ... of the
//     cluster (under ROWGATE, of each row whose own gate passes at its
//     turn; lanes 0-3 test the row boxes at once): neighbouring lanes read
//     neighbouring triangles, 128 coalesced bytes a plane. Each lane keeps
//     its own strict-'<' (t, id) from the ray's cap; a butterfly of
//     __shfl_xor_sync takes the lexicographic minimum, which becomes the
//     ray's hit when it beats the cap. A candidate's t does not depend on
//     the cap, so this is the serial sweep's result, ties to the lowest id
//     (tests/test_torch_hit_order.py holds the argument on the CPU).
//   - A warp's time is its own ray's visits; a heavy ray costs 16
//     iterations a cluster (4 a row) instead of 512 (128). Blocks of 4
//     warps take 4 consecutive rays, and the block scheduler hands the
//     blocks out as SMs free up, so heavy rays do not hold an SM idle.
// Measured, with chip_ab.py against the parent's kernel on the same inputs
// (H100 80GB HBM3 at 700 W): the sorted primary wavefront of terrain chunk 2
// (414,720 rays) VPU 5.46 ms against 8.45, ROWGATE 2.73 against 3.50; its
// sorted bounce-2 wavefront (193,363 live) VPU 2.11 against 14.8, ROWGATE
// 1.13 against 8.85. On the primary wavefront every pair reads its own
// triangle, 18 KB a visit a ray where the parent read it once a warp: the
// L1 and L2 traffic of some 47 million warp-iterations is what takes the
// time there. Tried and not kept (PERF.md §6): a warp taking 4 or 16
// consecutive rays in turn, blocks of 8 warps, and a warp-wide skip of v,
// t and the accept test when no lane's u lies in [0, 1] (none faster on
// both wavefronts).
//
// Numerics: mesh_common.cuh (every op rounded on its own, the TPU kernel's
// expression tree). In ascending triangle order, the strict '<' update of
// the running minimum is the TPU's per-row min-then-match followed by its
// strict 'better'. A dead lane gets t = BIG and idx = 0 (the TPU leaves dead
// lanes unspecified; every caller masks them).
//
// A4, qtrt_mesh_first_cluster, replaces _c1_kernel
// (qt_raytracer_tpu/kernels/mesh_intersect.py:619, first_crossed_cluster
// :688): per ray, the lowest id of a cluster whose slacked, capped slab test
// passes (k when none), which keys the wavefront sort that runs before A3;
// with a second output (pair=True on the TPU, a template flag here) also
// the lowest crossed id above it, for the two-cluster sort key. Its plain
// versions are first_crossed_cluster_plain (ungated) and
// crossing_walk_gated_plain (the walk below, counting its tests).
//   - What bounded it. The parent kernel, one thread a ray, tested the
//     cluster boxes in ascending id up to the first that passed: on the
//     1080p terrain (195 clusters) that id averages about 100, and a ray
//     that crosses nothing tests all 195; 20 single-rounded operations a
//     test, so instructions, and a warp paid its slowest lane.
//   - What the design does. The two-level walk of mesh_common.cuh
//     (crossing_walk): the box of each run of GROUP_C = 16 clusters
//     (MeshClusters.group_boxes, their exact union) first, its members only
//     when it passes, which drops no id; the live lanes packed in lane
//     order (take_ray, block_pack.cuh) where there is more than one group;
//     with one cluster, its box is the one group's, and one test decides.
//     A live terrain ray then tests some 18-21 boxes (chip_smoke.py counts
//     them), and what bounds the kernel is its bytes: 33 a ray (37 with
//     the second output).
//   - Measured (chip_ab.py --parts boxes against the parent kernel on the
//     same inputs, in turns, one call between two CUDA events, the
//     wrapper's host time included; NVIDIA H100 80GB HBM3 at 700 W), ms
//     against the parent's: terrain chunk 2, 414,720 rays, 0.099-0.100
//     against 0.139-0.148 (sorted: 0.061-0.077 against 0.095-0.099);
//     chunk 0, whose rays mostly cross nothing, 0.054-0.057 against
//     0.146-0.149; the bounce-2 wavefront (193,363 live) 0.069 against
//     0.127-0.130; with the second output 0.094-0.097 and 0.116-0.117
//     against 0.143-0.156 and 0.182-0.187; a one-cluster Cornell
//     wavefront 0.066-0.067 against 0.067-0.069, mostly host time. In
//     turns over the four terrain wavefronts, groups of 16 took 5% less
//     time than groups of 8 and 11% less than groups of 32. Not kept
//     (PERF.md §6): one warp a ray, the walk with only one of its two
//     kinds of member round.

#include <cuda_runtime.h>

#include "mesh_common.cuh"

namespace {

using namespace qtrt_mesh;

// A4: thread t walks the ray take_ray gives it (the block's live rays
// packed where there is more than one group); c1, and for PAIR c2, are the
// first one or two ids the walk visits. A dead lane writes k where it
// lies.
template <bool PAIR>
__global__ void __launch_bounds__(BLOCK) first_cluster_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const float* __restrict__ t_cap,
    const float* __restrict__ boxes, int k, int k_stride,
    const float* __restrict__ groups, int ng, float t_min, int n,
    int* __restrict__ out, int* __restrict__ out2) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool pack = ng > 1;
  if (pack && i < n && !alive[i]) {
    out[i] = k;
    if constexpr (PAIR) out2[i] = k;
  }
  int ray;
  Ray r = {};
  float cap = 0.f;
  const bool mine = take_ray(pack, n, ox, oy, oz, dx, dy, dz, alive, t_cap,
                             ray, r, cap);
  int c1 = k;
  int c2 = k;  // the next crossed id above c1; sought only when PAIR
  if (k == 1) {
    // One cluster, whose box is the one group's: one test decides.
    if (mine && gate_box(boxes, static_cast<size_t>(k_stride), 0, r, t_min,
                         cap))
      c1 = 0;
  } else {
    crossing_walk(mine, r, t_min, cap, groups, ng, boxes,
                  static_cast<size_t>(k_stride), k, [&](int c) {
                    if (PAIR && c1 == k) {
                      c1 = c;
                      return false;
                    }
                    if (PAIR) c2 = c; else c1 = c;
                    return true;
                  });
  }
  if (pack ? !mine : i >= n) return;  // unpacked, a dead lane writes k here
  out[ray] = c1;
  if constexpr (PAIR) out2[ray] = c2;
}

// A3's bodies (the header comment).
enum SearchMode : int { VPU = 0, ROWGATE = 1, MXU = 2 };

constexpr int SEARCH_WARPS = 4;  // rays per block of A3, one warp each
constexpr int NO_ID = 0x7fffffff;

// One lane's share of triangles [lo, hi): lo + lane, lo + lane + 32, ...,
// in ascending order, with the strict '<' update of the lane's own (t, id),
// which starts at (the ray's t_best, NO_ID). It ends on the lexicographic
// minimum of (t, id) over the lane's triangles accepted below t_best.
template <bool EXCL, int MODE>
__device__ __forceinline__ void lane_sweep(const float* __restrict__ tris,
                                           size_t ps, int lo, int hi,
                                           int lane, const Ray& r,
                                           const float d[3], const float m[3],
                                           float t_min, int ex, float& t,
                                           int& id) {
#pragma unroll 4
  for (int p = lo + lane; p < hi; p += WARP) {
    float t_hit;
    bool ok;
    if constexpr (MODE == MXU) {
      float f[MT_FEATURES];
#pragma unroll
      for (int a = 0; a < MT_FEATURES; ++a) f[a] = __ldg(tris + a * ps + p);
      ok = moller_trumbore_bilinear(r.o, d, m, f, t_min, t, t_hit);
    } else {
      float v0[3], e1[3], e2[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        v0[a] = __ldg(tris + a * ps + p);
        e1[a] = __ldg(tris + (3 + a) * ps + p);
        e2[a] = __ldg(tris + (6 + a) * ps + p);
      }
      ok = moller_trumbore(r.o, d, v0, e1, e2, t_min, t, t_hit);
    }
    if constexpr (EXCL) ok = ok && p != ex;
    if (ok) {
      t = t_hit;
      id = p;
    }
  }
}

// Triangles [lo, hi) for the warp's ray: each lane sweeps its share, the
// warp takes the lexicographic minimum of the lanes' (t, id), and that
// becomes the ray's running hit when it beats t_best. A candidate's t does
// not depend on the cap, so this is the serial strict-'<' sweep's result.
// Every lane of the warp calls it and leaves with the same (t_best, best).
template <bool EXCL, int MODE>
__device__ __forceinline__ void warp_sweep(const float* __restrict__ tris,
                                           size_t ps, int lo, int hi,
                                           int lane, const Ray& r,
                                           const float d[3], const float m[3],
                                           float t_min, int ex, float& t_best,
                                           int& best) {
  float t = t_best;
  int id = NO_ID;
  lane_sweep<EXCL, MODE>(tris, ps, lo, hi, lane, r, d, m, t_min, ex, t, id);
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1) {
    const float t2 = __shfl_xor_sync(FULL, t, off);
    const int id2 = __shfl_xor_sync(FULL, id, off);
    if (t2 < t || (t2 == t && id2 < id)) {
      t = t2;
      id = id2;
    }
  }
  if (t < t_best) {
    t_best = t;
    best = id;
  }
}

// A3 for ray i, on the warp that calls it (the header comment). Lane j
// slab-tests clusters base + j; the warp visits, in ascending order, each
// cluster whose test passes under the ray's running cap at that moment,
// and under ROWGATE each of its rows whose own test passes so.
template <bool EXCL, int MODE>
__device__ __forceinline__ void search_ray(
    int i, int lane, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const float* __restrict__ t_cap,
    const int* __restrict__ excl, const float* __restrict__ tris, size_t ps,
    const float* __restrict__ rows, size_t rs,
    const float* __restrict__ boxes, int k, size_t ks, int g, float t_min,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  float d[3];
  const Ray r = load_ray(i, ox, oy, oz, dx, dy, dz, d);
  const float cap0 = t_cap[i];
  int ex = -1;  // the ray's excluded triangle id; read only when EXCL
  if constexpr (EXCL) ex = excl[i];
  float m[3] = {0.f, 0.f, 0.f};  // o x d, read only by MXU
  if constexpr (MODE == MXU) ray_moment(r.o, d, m);
  float t_best = cap0;
  int best = 0;
  for (int base = 0; base < k; base += WARP) {
    const int j = base + lane;
    float enter = 0.f;
    // Under the cap at the start of these 32 clusters, which only shrinks:
    // each is tested again under the cap of its turn.
    const bool pass =
        j < k &&
        slab_box(__ldg(boxes + j), __ldg(boxes + ks + j),
                 __ldg(boxes + 2 * ks + j), __ldg(boxes + 3 * ks + j),
                 __ldg(boxes + 4 * ks + j), __ldg(boxes + 5 * ks + j), r,
                 t_min, enter) &&
        enter <= gate_cap(t_best);
    for (unsigned todo = __ballot_sync(FULL, pass); todo; todo &= todo - 1) {
      const int b = __ffs(todo) - 1;
      if (!(__shfl_sync(FULL, enter, b) <= gate_cap(t_best))) continue;
      const int lo = (base + b) * g;
      if constexpr (MODE == ROWGATE) {
        const int nrows = g / ROW;
        for (int rb = 0; rb < nrows; rb += WARP) {
          const int row = lo / ROW + rb + lane;
          float row_enter = 0.f;
          const bool row_pass =
              rb + lane < nrows &&
              slab_box(__ldg(rows + row), __ldg(rows + rs + row),
                       __ldg(rows + 2 * rs + row), __ldg(rows + 3 * rs + row),
                       __ldg(rows + 4 * rs + row), __ldg(rows + 5 * rs + row),
                       r, t_min, row_enter);
          for (unsigned rows_todo = __ballot_sync(FULL, row_pass); rows_todo;
               rows_todo &= rows_todo - 1) {
            const int c = __ffs(rows_todo) - 1;
            if (!(__shfl_sync(FULL, row_enter, c) <= gate_cap(t_best)))
              continue;
            const int p0 = lo + (rb + c) * ROW;
            warp_sweep<EXCL, MODE>(tris, ps, p0, p0 + ROW, lane, r, d, m,
                                   t_min, ex, t_best, best);
          }
        }
      } else {
        warp_sweep<EXCL, MODE>(tris, ps, lo, lo + g, lane, r, d, m, t_min,
                               ex, t_best, best);
      }
    }
  }
  if (lane == 0) {
    // A mesh hit counts only when some triangle beat the ray's cap.
    const bool won = t_best < cap0;
    t_out[i] = won ? t_best : BIG;
    idx_out[i] = won ? best : 0;
  }
}

// A3: warp w of block b takes ray b * SEARCH_WARPS + w.
template <bool EXCL, int MODE>
__global__ void __launch_bounds__(SEARCH_WARPS * WARP) mesh_search_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const float* __restrict__ t_cap,
    const int* __restrict__ excl, const float* __restrict__ tris, int p_stride,
    const float* __restrict__ rows, int r_stride,
    const float* __restrict__ boxes, int k, int k_stride, int g, float t_min,
    int n, float* __restrict__ t_out, int* __restrict__ idx_out) {
  const int lane = threadIdx.x & (WARP - 1);
  const int i = blockIdx.x * SEARCH_WARPS + threadIdx.x / WARP;
  if (i >= n) return;
  if (!alive[i]) {
    if (lane == 0) {
      t_out[i] = BIG;
      idx_out[i] = 0;
    }
    return;
  }
  search_ray<EXCL, MODE>(i, lane, ox, oy, oz, dx, dy, dz, t_cap, excl, tris,
                         static_cast<size_t>(p_stride), rows,
                         static_cast<size_t>(r_stride), boxes, k,
                         static_cast<size_t>(k_stride), g, t_min, t_out,
                         idx_out);
}

// Launch instance MODE of A3, with the exclude operand when excl is set.
template <int MODE>
void launch_search(cudaStream_t st, const float* ox, const float* oy,
                   const float* oz, const float* dx, const float* dy,
                   const float* dz, const bool* alive, const float* t_cap,
                   const int* excl, const float* tris, int p_stride,
                   const float* rows, int r_stride, const float* boxes, int k,
                   int k_stride, int g, float t_min, int n, float* t_out,
                   int* idx_out) {
  const int grid = n / SEARCH_WARPS + (n % SEARCH_WARPS != 0);
  if (excl != nullptr) {
    mesh_search_kernel<true, MODE><<<grid, SEARCH_WARPS * WARP, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, excl, tris, p_stride, rows,
        r_stride, boxes, k, k_stride, g, t_min, n, t_out, idx_out);
  } else {
    mesh_search_kernel<false, MODE><<<grid, SEARCH_WARPS * WARP, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, nullptr, tris, p_stride, rows,
        r_stride, boxes, k, k_stride, g, t_min, n, t_out, idx_out);
  }
}

}  // namespace

// Kernel A4. Ray operands: [n] f32 components, [n] bool alive, [n] f32
// t_cap (BIG for no cap); boxes: [6, k_stride] f32; groups: [6, ng] f32,
// the union of the boxes of each run of GROUP_C consecutive clusters
// (mesh_common.cuh), ng = ceil(k / GROUP_C); out: [n] i32, the first passing
// cluster id or k (dead lanes: k); out2: null, or [n] i32 for the next
// passing id above it (k when none). Launches on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int qtrt_mesh_first_cluster(const float* ox, const float* oy,
                                       const float* oz, const float* dx,
                                       const float* dy, const float* dz,
                                       const bool* alive, const float* t_cap,
                                       const float* boxes, int k,
                                       int k_stride, const float* groups,
                                       int ng, float t_min, int n, int* out,
                                       int* out2, void* stream) {
  if (n <= 0 || k <= 0 || k_stride < k ||
      ng != k / GROUP_C + (k % GROUP_C != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n / BLOCK + (n % BLOCK != 0);
  const auto st = static_cast<cudaStream_t>(stream);
  if (out2 != nullptr) {
    first_cluster_kernel<true><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, boxes, k, k_stride, groups, ng,
        t_min, n, out, out2);
  } else {
    first_cluster_kernel<false><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, boxes, k, k_stride, groups, ng,
        t_min, n, out, nullptr);
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
  const auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case VPU:
      launch_search<VPU>(st, ox, oy, oz, dx, dy, dz, alive, t_cap, excl, tris,
                         p_stride, nullptr, 0, boxes, k, k_stride, g, t_min,
                         n, t_out, idx_out);
      break;
    case ROWGATE:
      launch_search<ROWGATE>(st, ox, oy, oz, dx, dy, dz, alive, t_cap, excl,
                             tris, p_stride, rows, r_stride, boxes, k,
                             k_stride, g, t_min, n, t_out, idx_out);
      break;
    case MXU:
      launch_search<MXU>(st, ox, oy, oz, dx, dy, dz, alive, t_cap, excl, tris,
                         p_stride, nullptr, 0, boxes, k, k_stride, g, t_min,
                         n, t_out, idx_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
